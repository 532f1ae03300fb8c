// Chunk attention for Hopper (sm_90a), kernel E's fill form: NB chunks of C
// query tokens, chunk nb against ONE row rows[nb] of the stacked KV cache
// [L, B, KV, S, Dh] (bf16, or int8 with fp32 per-(token, kv head) scales
// [L, B, KV, S]), causal with an offset: chunk token c sees key j iff
// j <= offs[nb] + c. fp32 online softmax and accumulation, bf16 out.
// `chunk_attn.cu`'s entry points send every problem with more than 16
// packed query rows here (the fill form, C = 256); the verify form keeps
// the 16-row kernel there.
//
// Replaces: the Pallas TPU kernel `_chunk_kernel` of
//   metamorph_tpu/ops/decode_attention.py (driven by `chunk_attention`: one
//   prompt chunk of row `slot` at `chunk_off`, the chunked-fill step), bf16
//   and int8 branches.
//
// What bounds it on the H100: at C = 256 and G = 4 query heads per kv head
// every key row is used by G*C = 1024 query rows, 4*Dh FLOPs each: far above
// the card's ~295 FLOP/byte balance, so the tensor cores (989 TFLOP/s bf16,
// reached only through wgmma) bound it.
//
// What the design does about it (kernel A's structure, helpers in
// sm90.cuh):
//   * the G query heads of a kv head and the C chunk tokens are the G*C
//     rows of one problem: packed row i is chunk token i / G, head
//     kvh*G + i % G, so one K/V tile serves all G heads. A 128-row Q tile
//     is one TMA box of a 4-D map (Dh, heads, tokens, chunks) with
//     G heads x 128/G tokens, which lands in exactly that row order;
//   * one CTA per (128-row tile, kv head, chunk, key split): two consumer
//     warpgroups of 64 rows (wgmma's M) and a producer warpgroup whose one
//     thread issues TMA loads; `setmaxnreg` 240/24 (int8: 216/72);
//   * 128-key K/V tiles of the cache row stream through a 2-stage ring
//     under full/empty mbarriers; the K/V maps (Dh, S, kv heads, cache
//     rows) take the row from the device (rows[nb]), so keys past S arrive
//     as zeros and nothing is copied per layer;
//   * S = Q K^T is a wgmma from shared memory (both K-major), O += P V takes
//     P from registers and V as the MN-major B operand;
//   * the offset is a device value: each CTA stops at min(S, off + c_last
//     + 1), so stale cache past the chunk is never a tile of its own; in
//     the last tile such entries are masked, and only tiles that cross the
//     diagonal or S are masked at all;
//   * filling the card: at C = 256, G = 4 the 8 row tiles x 8 kv heads are
//     64 CTAs, under half of the 132 SMs, so the host splits each CTA's key
//     range into n_split parts (from S and the SM count, never from offs):
//     split s takes the s-th equal share of the CTA's key tiles. Each split
//     writes its fp32 partial (unnormalised O, m, l per row) to a
//     workspace, and the last split of a tile to arrive (an arrival
//     counter: __threadfence + atomicAdd) merges them in split order, in
//     the same launch, and resets the counter. With n_split = 1 the CTA
//     writes its output directly.
// int8: one thread of the producer warpgroup TMA-loads each int8 K/V tile
// (no swizzle) into a landing buffer; the whole producer warpgroup converts
// it into the ring's bf16 K and V stage, in the 128-byte swizzled layout
// wgmma reads (exact for |v| <= 127), stages the tile's k/v scales beside
// it (loaded from global memory before the wait, so their latency hides),
// and only then releases the landing buffer to the next tile's TMA. So the
// conversion and the next load overlap the consumers' products on the
// other stage; the consumers run exactly the bf16 loop. k_scale multiplies
// the fp32 score, v_scale multiplies P before its bf16 rounding, and the
// softmax sum takes the unscaled P.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;        // packed query rows per CTA
constexpr int BN = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int CONSUMERS = 256;
constexpr float NEG_INF = -1e30f;

template <int D, typename T>
struct FillSmem {
  static constexpr bool Q8 = sizeof(T) == 1;
  static constexpr int Q = BM * D * 2;             // the Q tile
  static constexpr int STG = BN * D * 2;           // one bf16 K (or V) stage
  static constexpr int LAND = Q8 ? BN * D : 0;     // an int8 tile as it lands
  static constexpr int SCL = Q8 ? STAGES * 2 * BN * 4 : 0;   // k/v scales
  // Q, the ring, the int8 landing tiles, scales, barriers, flag, alignment
  static constexpr int BYTES =
      Q + 2 * STAGES * STG + 2 * LAND + SCL + 64 + 16 + 1024;
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
chunk_fill_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  bf16* __restrict__ o, const int* __restrict__ rows,
                  const int* __restrict__ offs, int C, int H, int KV, int S,
                  int n_split, int64_t sc_layer_off, int64_t sc_sb,
                  int64_t sc_sh, float scale_log2, float* __restrict__ ws,
                  int* __restrict__ counters) {
  using SM = FillSmem<D, T>;
  constexpr bool Q8 = SM::Q8;
  constexpr int NCH = D / CHUNK;  // 64-column swizzle chunks of a row
  constexpr int QB = SM::Q;
  constexpr int STG = SM::STG;
  constexpr int LAND = SM::LAND;
  constexpr int NS = BN / 2;      // S accumulator floats per thread
  constexpr int NO = D / 2;       // O accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kst = qs + QB;                // bf16 K stages (wgmma's)
  unsigned char* vst = kst + STAGES * STG;     // bf16 V stages
  unsigned char* kland = vst + STAGES * STG;   // int8: the landing tiles
  unsigned char* vland = kland + LAND;
  float* scl = reinterpret_cast<float*>(vland + LAND);  // int8: [s][k|v][BN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(scl) + SM::SCL);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* land = empty + STAGES;
  int* flag = reinterpret_cast<int*>(land + 1);

  const int G = H / KV;
  const int GC = G * C;
  const int n_rt = (GC + BM - 1) / BM;
  const int rt = n_rt - 1 - (int)blockIdx.x / n_split;  // longest tiles first
  const int split = (int)blockIdx.x % n_split;
  const int kvh = blockIdx.y;
  const int nb = blockIdx.z;
  const int r_cta = rt * BM;
  const int row = rows[nb];
  const int off = offs[nb];
  const int c_last = (min(r_cta + BM, GC) - 1) / G;
  const int kv_end = max(0, min(S, off + c_last + 1));
  const int total = (kv_end + BN - 1) / BN;
  const int t_lo = split * total / n_split;
  const int n_tiles = (split + 1) * total / n_split - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // bf16: the TMA's one arrival; int8: every converting thread's
      mbar_init(&full[s], Q8 ? 128 : 1);
      mbar_init(&empty[s], CONSUMERS);   // every consumer thread releases
    }
    mbar_init(land, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int64_t sc_off = sc_layer_off + row * sc_sb + kvh * sc_sh;
  if constexpr (Q8) if (wg == 2) {
    // producer, int8: thread 256 lands each int8 K/V tile by TMA; the
    // warpgroup converts it into the bf16 stage and stages its scales while
    // the consumers work on the stage before
    reg_dealloc<72>();
    const int ptid = threadIdx.x - 256;
    if (n_tiles > 0 && ptid == 0) {
      mbar_arrive_expect_tx(q_full, QB);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(qs + c * BM * 128, &qmap, q_full, c * CHUNK, kvh * G,
                    r_cta / G, nb);
      mbar_arrive_expect_tx(land, 2 * LAND);
      tma_load_4d(kland, &kmap, land, 0, t_lo * BN, kvh, row);
      tma_load_4d(vland, &vmap, land, 0, t_lo * BN, kvh, row);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int key = (t_lo + j) * BN + ptid;
      const float ksv = key < S ? ks[sc_off + key] : 0.f;
      const float vsv = key < S ? vs[sc_off + key] : 0.f;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      mbar_wait(land, j & 1);
      // int8 [BN, D] rows -> bf16 in the swizzled layout, 16 values a step
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const unsigned char* src = w ? vland : kland;
        unsigned char* dst = (w ? vst : kst) + s * STG;
#pragma unroll 4
        for (int i = ptid; i < BN * D / 16; i += 128) {
          const int r = i / (D / 16);
          const int col = (i % (D / 16)) * 16;
          const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + col);
          float f[16];
          i8x4_to_f32(raw.x, f);
          i8x4_to_f32(raw.y, f + 4);
          i8x4_to_f32(raw.z, f + 8);
          i8x4_to_f32(raw.w, f + 12);
          uint32_t h[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            h[k] = pack_bf16_exact(f[2 * k], f[2 * k + 1]);
          unsigned char* base = dst + (col / CHUNK) * BN * 128 + r * 128;
          const int u = (col % CHUNK) / 8;   // 16-byte unit in the row
          *reinterpret_cast<uint4*>(base + ((u ^ (r & 7)) << 4)) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(base + (((u + 1) ^ (r & 7)) << 4)) =
              make_uint4(h[4], h[5], h[6], h[7]);
        }
      }
      scl[s * 2 * BN + ptid] = ksv;
      scl[s * 2 * BN + BN + ptid] = vsv;
      fence_proxy_async();            // the stage is wgmma's to read
      named_bar_sync(2, 128);         // every converter is done with land
      if (ptid == 0 && j + 1 < n_tiles) {
        mbar_arrive_expect_tx(land, 2 * LAND);
        tma_load_4d(kland, &kmap, land, 0, (t_lo + j + 1) * BN, kvh, row);
        tma_load_4d(vland, &vmap, land, 0, (t_lo + j + 1) * BN, kvh, row);
      }
      mbar_arrive(&full[s]);
    }
    return;
  }
  if constexpr (!Q8) if (wg == 2) {
    // producer, bf16: one thread keeps the ring full
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, QB);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(qs + c * BM * 128, &qmap, q_full, c * CHUNK, kvh * G,
                    r_cta / G, nb);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = (t_lo + j) * BN;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * STG);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(kst + s * STG + c * BN * 128, &kmap, &full[s],
                      c * CHUNK, k0, kvh, row);
          tma_load_4d(vst + s * STG + c * BN * 128, &vmap, &full[s],
                      c * CHUNK, k0, kvh, row);
        }
      }
    }
    return;
  }

  if constexpr (Q8) reg_alloc<216>();
  else reg_alloc<240>();
  const int ctid = threadIdx.x;   // 0..255 over both consumer warpgroups
  const int tid = ctid & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // row within the 8-row half of a warp
  const int tig = lane & 3;       // column pair within an 8-column block
  const int row_lo = r_cta + wg * 64;
  const int r0 = row_lo + warp * 16 + g;   // this thread's two packed rows
  const int r1 = r0 + 8;
  const int lim0 = off + r0 / G;           // the last key each may see
  const int lim1 = off + r1 / G;
  const int lim_first = off + row_lo / G;  // the warpgroup's first row's
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};               // partial sums over own columns

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = (t_lo + j) * BN;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t ka = smem_u32(kst + s * STG);
    const uint32_t va = smem_u32(vst + s * STG);
    const float* ksc_s = scl + s * 2 * BN;     // int8 only
    const float* vsc_s = ksc_s + BN;

    // S = Q K^T: 64 rows x 128 keys
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      mma_ss<BN, 0>(sc, desc_kmajor(qa + (kc / 4) * BM * 128 + (kc % 4) * 32),
                    desc_kmajor(ka + (kc / 4) * BN * 128 + (kc % 4) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<NS>(sc);

    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sc[i] *= ksc_s[(i / 4) * 8 + tig * 2 + (i & 1)];
    }
    // mask only a tile that crosses the diagonal or S
    if (k0 + BN - 1 > lim_first || k0 + BN > S) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + (i / 4) * 8 + tig * 2 + (i & 1);
        if (!(col < S && col <= ((i & 2) ? lim1 : lim0))) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with nothing visible yet keeps p = exp2(-inf) = 0
      ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      alpha[r] = exp2f(m[r] * scale_log2 - ms[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
      if constexpr (Q8) sc[i] *= vsc_s[(i / 4) * 8 + tig * 2 + (i & 1)];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P from the S registers as the bf16 A operand, V MN-major
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
      pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
      pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
      pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
      mma_rs<D, 1>(oacc, pa[kc], desc_mnmajor(va + kc * 16 * 128, BN * 128),
                   1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<NO>(oacc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // packed row r -> o[nb, r / G, kvh * G + r % G, :]
  auto orow = [&](int r) {
    return o + (((int64_t)nb * C + r / G) * H + kvh * G + r % G) * D;
  };

  if (n_split == 1) {
    const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
    const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
#pragma unroll
    for (int nbk = 0; nbk < D / 8; ++nbk) {
      const int c = nbk * 8 + tig * 2;
      if (r0 < GC)
        *reinterpret_cast<uint32_t*>(orow(r0) + c) =
            pack_bf16(oacc[4 * nbk] * inv0, oacc[4 * nbk + 1] * inv0);
      if (r1 < GC)
        *reinterpret_cast<uint32_t*>(orow(r1) + c) =
            pack_bf16(oacc[4 * nbk + 2] * inv1, oacc[4 * nbk + 3] * inv1);
    }
    return;
  }

  // this split's partial: unnormalised O [BM, D], then (m, l) per row, m in
  // the log2 domain; ws holds [P][BM][D] floats, then [P][BM][2]
  const int64_t n_part = (int64_t)gridDim.x * KV * gridDim.z;
  const int64_t tile_id = ((int64_t)nb * KV + kvh) * n_rt + rt;
  const int64_t pidx = tile_id * n_split + split;
  float* ws_ml = ws + n_part * BM * D;
  {
    float* po = ws + pidx * BM * D;
    const int rl0 = r0 - r_cta;
    const int rl1 = r1 - r_cta;
#pragma unroll
    for (int nbk = 0; nbk < D / 8; ++nbk) {
      const int c = nbk * 8 + tig * 2;
      *reinterpret_cast<float2*>(po + rl0 * D + c) =
          make_float2(oacc[4 * nbk], oacc[4 * nbk + 1]);
      *reinterpret_cast<float2*>(po + rl1 * D + c) =
          make_float2(oacc[4 * nbk + 2], oacc[4 * nbk + 3]);
    }
    if (tig == 0) {
      float* ml = ws_ml + pidx * BM * 2;
      ml[rl0 * 2] = l[0] > 0.f ? m[0] * scale_log2 : NEG_INF;
      ml[rl0 * 2 + 1] = l[0];
      ml[rl1 * 2] = l[1] > 0.f ? m[1] * scale_log2 : NEG_INF;
      ml[rl1 * 2 + 1] = l[1];
    }
  }
  // arrival: the last split of this tile merges every partial
  __threadfence();
  named_bar_sync(1, CONSUMERS);
  if (ctid == 0) {
    int* ctr = counters + tile_id;
    const int last = atomicAdd(ctr, 1) == n_split - 1;
    if (last) *ctr = 0;             // every split has arrived: ready to reuse
    *flag = last;
  }
  named_bar_sync(1, CONSUMERS);
  if (!*flag) return;
  __threadfence();
  const int64_t p0 = tile_id * n_split;
  for (int i = ctid; i < BM * D / 4; i += CONSUMERS) {
    const int rl = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    if (r_cta + rl >= GC) continue;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) {
      const float* ml = ws_ml + ((p0 + s) * BM + rl) * 2;
      if (__ldcg(ml + 1) > 0.f) M = fmaxf(M, __ldcg(ml));
    }
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float* ml = ws_ml + ((p0 + s) * BM + rl) * 2;
      const float ls = __ldcg(ml + 1);
      if (ls > 0.f) {              // an empty partial holds no O
        const float f = exp2f(__ldcg(ml) - M);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            ws + ((p0 + s) * BM + rl) * D + d));
        L += ls * f;
        O.x += x.x * f;
        O.y += x.y * f;
        O.z += x.z * f;
        O.w += x.w * f;
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    *reinterpret_cast<uint2*>(orow(r_cta + rl) + d) =
        make_uint2(pack_bf16(O.x * inv, O.y * inv),
                   pack_bf16(O.z * inv, O.w * inv));
  }
}

template <int D, typename T>
int launch_fill(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, bf16* o, const int* rows, const int* offs,
                int NB, int C, int H, int KV, int S, int Bc,
                int64_t layer_off, int64_t c_sb, int64_t c_sh,
                int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
                float scale_log2, int n_split, float* ws, int* counters,
                cudaStream_t st) {
  constexpr bool Q8 = sizeof(T) == 1;
  const int G = H / KV;
  const int n_rt = (G * C + BM - 1) / BM;
  // q [NB, C, H, D]: a box of G heads x BM / G tokens is BM packed rows
  CUtensorMap qm, km, vm;
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)C,
                          (uint64_t)NB};
  const int64_t qs[3] = {(int64_t)D * 2, (int64_t)H * D * 2,
                         (int64_t)C * H * D * 2};
  const uint32_t qbox[4] = {(uint32_t)CHUNK, (uint32_t)G,
                            (uint32_t)(BM / G), 1};
  int err = make_map_box(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, qd, qs,
                         qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  // the layer's cache [Bc, KV, S, D] through the wrapper's strides
  const T* kb = static_cast<const T*>(k) + layer_off;
  const T* vb = static_cast<const T*>(v) + layer_off;
  if constexpr (Q8) {
    // int8 rows of D bytes, one box per tile, no swizzle
    const uint64_t kd[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)KV,
                            (uint64_t)Bc};
    const int64_t kst[3] = {(int64_t)D, c_sh, c_sb};
    const uint32_t kbox[4] = {(uint32_t)D, (uint32_t)BN, 1, 1};
    if (!err)
      err = make_map_box(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, kb, kd, kst,
                         kbox, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err)
      err = make_map_box(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, vb, kd, kst,
                         kbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    if (!err) err = make_map(&km, kb, D, S, KV, Bc, D, c_sh, c_sb, BN);
    if (!err) err = make_map(&vm, vb, D, S, KV, Bc, D, c_sh, c_sb, BN);
  }
  if (err) return err;
  constexpr int bytes = FillSmem<D, T>::BYTES;
  const cudaError_t e = smem_opt_in<chunk_fill_kernel<D, T>>(bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_rt * n_split, KV, NB);
  chunk_fill_kernel<D, T><<<grid, THREADS, bytes, st>>>(
      qm, km, vm, ks, vs, o, rows, offs, C, H, KV, S, n_split, sc_layer_off,
      sc_sb, sc_sh, scale_log2, ws, counters);
  return (int)cudaGetLastError();
}

template <typename T>
int fill(const void* q, const void* k, const void* v, const float* ks,
         const float* vs, void* o, const int* rows, const int* offs, int NB,
         int C, int H, int KV, int S, int D, int Bc, int64_t layer_off,
         int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
         int64_t sc_sh, float scale_log2, int n_split, float* ws,
         int* counters, void* stream) {
  const int n_rt = ((H / KV) * C + BM - 1) / BM;
  if (Bc <= 0 || n_split <= 0 || (int64_t)n_rt * n_split > 0x7fffffff ||
      NB > 65535 || KV > 65535 ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_fill<128, T>(q, k, v, ks, vs, op, rows, offs, NB, C, H, KV,
                               S, Bc, layer_off, c_sb, c_sh, sc_layer_off,
                               sc_sb, sc_sh, scale_log2, n_split, ws,
                               counters, st);
  if (D == 64)
    return launch_fill<64, T>(q, k, v, ks, vs, op, rows, offs, NB, C, H, KV,
                              S, Bc, layer_off, c_sb, c_sh, sc_layer_off,
                              sc_sb, sc_sh, scale_log2, n_split, ws, counters,
                              st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Called by chunk_attn.cu's entry points for the fill form (more than 16
// packed query rows); the arguments are theirs plus Bc, the cache rows, and
// the key split (ws: NB * KV * row tiles * n_split * 128 * (D + 2) floats,
// counters: NB * KV * row tiles ints, zero before the first launch and left
// zero by each launch; both unused with n_split = 1).
int mm_chunk_fill_bf16(const void* q, const void* k, const void* v, void* o,
                       const int* rows, const int* offs, int NB, int C, int H,
                       int KV, int S, int D, int Bc, int64_t layer_off,
                       int64_t c_sb, int64_t c_sh, float scale_log2,
                       int n_split, float* ws, int* counters, void* stream) {
  return fill<bf16>(q, k, v, nullptr, nullptr, o, rows, offs, NB, C, H, KV,
                    S, D, Bc, layer_off, c_sb, c_sh, 0, 0, 0, scale_log2,
                    n_split, ws, counters, stream);
}

int mm_chunk_fill_int8(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale, void* o,
                       const int* rows, const int* offs, int NB, int C, int H,
                       int KV, int S, int D, int Bc, int64_t layer_off,
                       int64_t c_sb, int64_t c_sh, int64_t sc_layer_off,
                       int64_t sc_sb, int64_t sc_sh, float scale_log2,
                       int n_split, float* ws, int* counters, void* stream) {
  return fill<int8_t>(q, k, v, k_scale, v_scale, o, rows, offs, NB, C, H, KV,
                      S, D, Bc, layer_off, c_sb, c_sh, sc_layer_off, sc_sb,
                      sc_sh, scale_log2, n_split, ws, counters, stream);
}
