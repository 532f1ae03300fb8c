// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/do in, fp32
// logsumexp and delta in, fp32 accumulation, bf16 dq/dk/dv out.
//
// Replaces: the four Pallas TPU backward kernels of
//   metamorph_tpu/ops/flash_attention.py.
//   Kernel C (`flash_bwd_dq_kernel`) replaces `_bwd_dq_kernel_tri` (the
//   causal triangle grid, driven by `_bwd_tri`) and `_bwd_dq_kernel` (the
//   rectangular grid with the lse cotangent, driven by `_bwd`).
//   Kernel D (`flash_bwd_dkv_kernel`) replaces `_bwd_dkv_kernel_tri` and
//   `_bwd_dkv_kernel`. The TPU kernels write dk/dv per q head and leave the
//   GQA group sum to XLA after a cast to q's dtype; kernel D sums the group
//   in fp32 inside the CTA and rounds once.
//   The TPU's triangle block lists were a grid device for a machine whose
//   grid runs in order on one core; here CTAs run in parallel and each one
//   loops over just the tiles that can see it, so no block list is needed.
//
// What bounds it on the H100: four tile products per (q tile, key tile)
// pair — S = Q K^T, dP = dO V^T, then dQ += dS K (kernel C) or dV += P^T dO
// and dK += dS^T Q (kernel D), about 4*2*Dh FLOPs per visible (query, key)
// pair each (kernel C recomputes S and dP as kernel D does). At T >= 1024
// and Dh = 128 that is far above the card's ~295 FLOP/byte balance point:
// the tensor cores are the resource that matters.
//
// What the design does about it: every product runs on the tensor cores
// through wgmma, tiles arrive by TMA while the previous one is used, and the
// softmax never leaves registers. Both kernels share one shape (helpers in
// sm90.cuh): two consumer warpgroups of 64 rows (or keys) each, and one
// thread of a producer warpgroup that issues the TMA loads into a 2-stage
// ring of shared-memory stages guarded by full/empty mbarriers;
// `setmaxnreg` moves registers from the producer (24) to the consumers
// (240).
//   * Kernel C: one CTA per (q head, batch row, 128-row q tile), the
//     heaviest causal q tiles launched first (the tile index counts down).
//     Q and dO arrive once and stay in shared memory; each thread reads the
//     lse and delta of its two q rows once. The producer streams (K, V)
//     tiles of 64 keys up to min(length, causal end). Per tile, S = Q K^T
//     and dP = dO V^T are wgmma m64n64k16 from shared memory (all
//     K-major); dS = P (dP - dd) scale leaves the fp32 accumulator straight
//     in the register A layout of dQ += dS K, a wgmma with K read as an
//     MN-major B operand. Both warpgroups run every key tile of the CTA
//     (the lower one's last causal tile gives P = 0): a branch around the
//     wgmma chains makes ptxas serialise them (C7520), which measured
//     slower than the wasted tile. dQ stays in fp32 registers (Dh/2 per
//     thread) and is written once.
//   * Kernel D: one CTA per (kv head, batch row, 128-key tile), key tile 0
//     (the heaviest when causal) launched first; each consumer warpgroup
//     owns 64 keys. K and V are loaded once; the producer then streams
//     (Q, dO) tiles of 64 q rows, with their lse and delta rows, of every q
//     head of the group — from the first q tile that can see the key tile
//     (causal) to the end. Per tile, S^T = K Q^T and dP^T = V dO^T are
//     wgmma m64n64k16 from shared memory (all K-major); P^T and dS^T come
//     out of those accumulators already in the register A layout of
//     dV += P^T dO and dK += dS^T Q, which are wgmma with dO and Q read as
//     MN-major (transposed) B operands. dK and dV stay in fp32 registers
//     across the whole group and are written once.
//   In both, only tiles that cross the diagonal, the length or T are masked.
//
// Semantics held to the Pallas kernels: key j is visible to query row i iff
// j < length[b] and (not causal or j <= i). P = exp(S*scale - lse) with the
// scale applied in fp32 to the fp32 scores; a masked entry gets P = 0
// whatever its exp gives, so a row with no visible key (lse = -1e30)
// contributes nothing and gets dq = 0. dS = P * (dP - dd) * scale with
// dd = delta - dlse (the lse cotangent, zero when the lse was not used).
// Inputs and outputs are addressed through strides, so the model layout
// [B, T, H, Dh] needs no copies. No atomics: two launches on the same
// inputs give equal bits.

#include "sm90.cuh"

namespace {

using sm90::bf16;
using sm90::pack_bf16;

constexpr float LOG2E = 1.44269504088896340736f;

// ---------------------------------------------------------------------------
// kernel C: dq
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 128;       // q rows per CTA: two consumer warpgroups
constexpr int DQ_BN = 64;        // keys per streamed tile
constexpr int DQ_STAGES = 2;     // (K, V) ring depth
constexpr int DQ_THREADS = 384;  // 2 consumer warpgroups + 1 producer

template <int D>
struct DqSmem {
  static constexpr int QD = DQ_BM * D * 2;     // bytes: the Q (or dO) tile
  static constexpr int KV = DQ_BN * D * 2;     // one K (or V) stage
  static constexpr int BYTES = 2 * QD + DQ_STAGES * 2 * KV + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    const int* __restrict__ lengths, int H, int KV, int T,
                    int S, int64_t g_sb, int64_t g_sh, int64_t g_st,
                    float scale, int causal) {
  using namespace sm90;
  constexpr int NCH = D / CHUNK;
  constexpr int QDB = DqSmem<D>::QD;
  constexpr int KVB = DqSmem<D>::KV;
  constexpr int NQ = D / 2;        // dQ accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dos = qs + QDB;
  unsigned char* ks = dos + QDB;                // DQ_STAGES K tiles
  unsigned char* vs = ks + DQ_STAGES * KVB;     // DQ_STAGES V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + DQ_STAGES * KVB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BM;   // heaviest first
  const int kvh = h / (H / KV);
  const int length = max(0, min(lengths[b], S));
  const int kv_end = causal ? min(length, q0 + DQ_BM) : length;
  const int n_tiles = (kv_end + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q and dO once, then (K, V) tiles through the ring
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, 2 * QDB);
      for (int c = 0; c < NCH; ++c) {
        tma_load_4d(qs + c * DQ_BM * 128, &qmap, q_full, c * CHUNK, q0, h,
                    b);
        tma_load_4d(dos + c * DQ_BM * 128, &dmap, q_full, c * CHUNK, q0, h,
                    b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % DQ_STAGES;
        mbar_wait(&empty[s], ((j / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * KVB);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(ks + s * KVB + c * DQ_BN * 128, &kmap, &full[s],
                      c * CHUNK, j * DQ_BN, kvh, b);
          tma_load_4d(vs + s * KVB + c * DQ_BN * 128, &vmap, &full[s],
                      c * CHUNK, j * DQ_BN, kvh, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int row_lo = q0 + wg * 64;           // this warpgroup's first row
    const int r0 = row_lo + warp * 16 + g;     // this thread's two q rows
    const int r1 = r0 + 8;
    const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
    const uint32_t da = smem_u32(dos) + wg * 64 * 128;
    const float* lrow = lse + ((int64_t)b * H + h) * T;
    const float* drow = dd + ((int64_t)b * H + h) * T;
    const float lse2[2] = {r0 < T ? lrow[r0] * LOG2E : 0.f,
                           r1 < T ? lrow[r1] * LOG2E : 0.f};
    const float ddr[2] = {r0 < T ? drow[r0] : 0.f, r1 < T ? drow[r1] : 0.f};
    const float scale_log2 = scale * LOG2E;

    float dqa[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) dqa[i] = 0.f;

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % DQ_STAGES;
      const int k0 = j * DQ_BN;
      mbar_wait(&full[s], (j / DQ_STAGES) & 1);
      const uint32_t ka = smem_u32(ks + s * KVB);
      const uint32_t va = smem_u32(vs + s * KVB);
      // S = Q K^T and dP = dO V^T: 64 q rows x 64 keys, all K-major
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      // each chain's register operands are set before its wgmma.fence: a
      // definition the compiler sinks past the fence makes ptxas inject a
      // warpgroup wait (C7517/C7519), measured 5-8 % slower
      fence_operands<32>(st);
      fence_operands<32>(dpt);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t qo = (kc / 4) * DQ_BM * 128 + (kc % 4) * 32;
        const uint32_t ko = (kc / 4) * DQ_BN * 128 + (kc % 4) * 32;
        mma_ss<64, 0>(st, desc_kmajor(qa + qo), desc_kmajor(ka + ko), 1);
        mma_ss<64, 0>(dpt, desc_kmajor(da + qo), desc_kmajor(va + ko), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<32>(st);
      fence_operands<32>(dpt);

      // dS = P (dP - dd) scale; rows are q rows, columns keys. Only a
      // tile that crosses the length or the diagonal is masked.
      const bool need_mask =
          k0 + DQ_BN > length || (causal && k0 + DQ_BN - 1 > row_lo);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(st[i], scale_log2, -lse2[r]));
        if (need_mask) {
          const int key = k0 + (i / 4) * 8 + tig * 2 + (i & 1);
          if (!(key < length && (!causal || key <= (r ? r1 : r0))))
            p = 0.f;
        }
        st[i] = p * (dpt[i] - ddr[r]) * scale;
      }
      uint32_t sa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sa[kc][r] = pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
      // dQ += dS K: depth = the tile's 64 keys, K read MN-major
      fence_operands<16>(&sa[0][0]);
      fence_operands<NQ>(dqa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        mma_rs<D, 1>(dqa, sa[kc],
                     desc_mnmajor(ka + kc * 16 * 128, DQ_BN * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<NQ>(dqa);
      mbar_arrive(&empty[s]);
    }

    bf16* gb = dq + b * g_sb + h * g_sh;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + tig * 2;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(gb + r0 * g_st + c) =
            pack_bf16(dqa[4 * nb], dqa[4 * nb + 1]);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(gb + r1 * g_st + c) =
            pack_bf16(dqa[4 * nb + 2], dqa[4 * nb + 3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* d,
              const float* lse, const float* dd, bf16* dq, const int* lengths,
              int B, int H, int KV, int T, int S, const int64_t* sd,
              float scale, int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, dm;
  int err = sm90::make_map(&qm, q, D, T, H, B, sd[2], sd[1], sd[0], DQ_BM);
  if (!err)
    err = sm90::make_map(&km, k, D, S, KV, B, sd[5], sd[4], sd[3], DQ_BN);
  if (!err)
    err = sm90::make_map(&vm, v, D, S, KV, B, sd[8], sd[7], sd[6], DQ_BN);
  if (!err)
    err = sm90::make_map(&dm, d, D, T, H, B, sd[11], sd[10], sd[9], DQ_BM);
  if (err) return err;
  constexpr int bytes = DqSmem<D>::BYTES;
  const cudaError_t e = sm90::smem_opt_in<flash_bwd_dq_kernel<D>>(bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (T + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, bytes, st>>>(
      qm, km, vm, dm, lse, dd, dq, lengths, H, KV, T, S, sd[12], sd[13],
      sd[14], scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel D: dk, dv
// ---------------------------------------------------------------------------

constexpr int DKV_BN = 128;      // keys per CTA: two consumer warpgroups
constexpr int DKV_BM = 64;       // q rows per streamed tile
constexpr int DKV_STAGES = 2;    // (Q, dO, lse, delta) ring depth
constexpr int DKV_THREADS = 384; // 2 consumer warpgroups + 1 producer
// lse and delta rows come by TMA from the contiguous [B*H*T] vectors. A box
// has to start at a 16-byte aligned address, so each stage loads the
// DKV_ROWS-element window that starts at the q tile's first row rounded down
// to a multiple of 4; the tile's rows sit 0-3 elements into it.
constexpr int DKV_ROWS = DKV_BM + 4;
// a TMA destination has to be 128-byte aligned: stages 384 bytes apart
constexpr int DKV_ROWS_PAD = DKV_BM + 32;

template <int D>
struct DkvSmem {
  static constexpr int KV = DKV_BN * D * 2;      // bytes: the K (or V) tile
  static constexpr int QD = DKV_BM * D * 2;      // one Q (or dO) stage
  static constexpr int ROWS = DKV_ROWS_PAD * 4;  // one lse (or delta) stage
  static constexpr int BYTES =
      2 * KV + DKV_STAGES * (2 * QD + 2 * ROWS) + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap lmap,
                     const __grid_constant__ CUtensorMap ddmap,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const int* __restrict__ lengths, int H, int KV, int T,
                     int S, int64_t gk_sb, int64_t gk_sh, int64_t gk_st,
                     int64_t gv_sb, int64_t gv_sh, int64_t gv_st, float scale,
                     int causal) {
  using namespace sm90;
  constexpr int NCH = D / CHUNK;
  constexpr int KVB = DkvSmem<D>::KV;
  constexpr int QDB = DkvSmem<D>::QD;
  constexpr int NA = D / 2;        // dK (and dV) accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* vs = ks + KVB;
  unsigned char* qs = vs + KVB;                 // DKV_STAGES Q tiles
  unsigned char* dos = qs + DKV_STAGES * QDB;   // DKV_STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + DKV_STAGES * QDB);
  float* dd_s = lse_s + DKV_STAGES * DKV_ROWS_PAD;
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(dd_s + DKV_STAGES * DKV_ROWS_PAD);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.z * DKV_BN;   // key tile 0, the heaviest, first
  const int G = H / KV;
  const int length = max(0, min(lengths[b], S));
  // the first q tile that can see a key of this tile; a key tile past the
  // length (or, causal, past every q row) gets zeros
  const int i_begin = causal ? j0 : 0;
  const int nq = i_begin < T ? (T - i_begin + DKV_BM - 1) / DKV_BM : 0;
  const int n_tiles = j0 < length ? G * nq : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: K/V once, then (Q, dO, lse, delta) of every q tile of every
    // q head of the group through the ring
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * KVB);
      for (int c = 0; c < NCH; ++c) {
        tma_load_4d(ks + c * DKV_BN * 128, &kmap, kv_full, c * CHUNK, j0, kvh,
                    b);
        tma_load_4d(vs + c * DKV_BN * 128, &vmap, kv_full, c * CHUNK, j0, kvh,
                    b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % DKV_STAGES;
        const int gi = t / nq;
        const int h = kvh * G + gi;
        const int i0 = i_begin + (t - gi * nq) * DKV_BM;
        mbar_wait(&empty[s], ((t / DKV_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * QDB + 2 * DKV_ROWS * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(qs + s * QDB + c * DKV_BM * 128, &qmap, &full[s],
                      c * CHUNK, i0, h, b);
          tma_load_4d(dos + s * QDB + c * DKV_BM * 128, &dmap, &full[s],
                      c * CHUNK, i0, h, b);
        }
        // rows past T read the next head's values (or zeros past the end);
        // the consumers mask them
        const int row = ((b * H + h) * T + i0) & ~3;
        tma_load_1d(lse_s + s * DKV_ROWS_PAD, &lmap, &full[s], row);
        tma_load_1d(dd_s + s * DKV_ROWS_PAD, &ddmap, &full[s], row);
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int kw = j0 + wg * 64;               // this warpgroup's first key
    const int key0 = kw + warp * 16 + g;       // this thread's two keys
    const int key1 = key0 + 8;
    const float scale_log2 = scale * LOG2E;
    const uint32_t ka = smem_u32(ks) + wg * 64 * 128;
    const uint32_t va = smem_u32(vs) + wg * 64 * 128;

    float dka[NA], dva[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;

    if (n_tiles > 0) mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % DKV_STAGES;
      const int gi = t / nq;
      const int i0 = i_begin + (t - gi * nq) * DKV_BM;
      const int skew = ((b * H + kvh * G + gi) * T) & 3;
      mbar_wait(&full[s], (t / DKV_STAGES) & 1);
      const uint32_t qa = smem_u32(qs + s * QDB);
      const uint32_t da = smem_u32(dos + s * QDB);
      const float* lrow = lse_s + s * DKV_ROWS_PAD + skew;
      const float* drow = dd_s + s * DKV_ROWS_PAD + skew;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows, all K-major
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t ko = (kc / 4) * DKV_BN * 128 + (kc % 4) * 32;
        const uint32_t qo = (kc / 4) * DKV_BM * 128 + (kc % 4) * 32;
        mma_ss<64, 0>(st, desc_kmajor(ka + ko), desc_kmajor(qa + qo), 1);
        mma_ss<64, 0>(dpt, desc_kmajor(va + ko), desc_kmajor(da + qo), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<32>(st);
      fence_operands<32>(dpt);

      // P^T and dS^T; rows are keys, columns q rows. The mask selects (a
      // masked column may hold another head's lse and delta).
      const bool need_mask = kw + 64 > length || i0 + DKV_BM > T ||
                             (causal && kw + 63 > i0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i / 4) * 8 + tig * 2 + (i & 1);
        float p = exp2f(fmaf(st[i], scale_log2, -lrow[col] * LOG2E));
        float ds = p * (dpt[i] - drow[col]) * scale;
        if (need_mask) {
          const int key = (i & 2) ? key1 : key0;
          const int qi = i0 + col;
          if (!(key < length && qi < T && (!causal || key <= qi)))
            p = ds = 0.f;
        }
        st[i] = p;
        dpt[i] = ds;
      }
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kc][r] = pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
          sa[kc][r] = pack_bf16(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
        }
      }
      // dV += P^T dO and dK += dS^T Q: depth = the 64 q rows, dO and Q
      // MN-major
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        mma_rs<D, 1>(dva, pa[kc],
                     desc_mnmajor(da + kc * 16 * 128, DKV_BM * 128), 1);
        mma_rs<D, 1>(dka, sa[kc],
                     desc_mnmajor(qa + kc * 16 * 128, DKV_BM * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<NA>(dka);
      fence_operands<NA>(dva);
      mbar_arrive(&empty[s]);
    }

    bf16* kout = dk + b * gk_sb + kvh * gk_sh;
    bf16* vout = dv + b * gv_sb + kvh * gv_sh;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + tig * 2;
      if (key0 < S) {
        *reinterpret_cast<uint32_t*>(kout + key0 * gk_st + c) =
            pack_bf16(dka[4 * nb], dka[4 * nb + 1]);
        *reinterpret_cast<uint32_t*>(vout + key0 * gv_st + c) =
            pack_bf16(dva[4 * nb], dva[4 * nb + 1]);
      }
      if (key1 < S) {
        *reinterpret_cast<uint32_t*>(kout + key1 * gk_st + c) =
            pack_bf16(dka[4 * nb + 2], dka[4 * nb + 3]);
        *reinterpret_cast<uint32_t*>(vout + key1 * gv_st + c) =
            pack_bf16(dva[4 * nb + 2], dva[4 * nb + 3]);
      }
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* d,
               const float* lse, const float* dd, bf16* dk, bf16* dv,
               const int* lengths, int B, int H, int KV, int T, int S,
               const int64_t* sd, float scale, int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, dm, lm, ddm;
  int err = sm90::make_map(&qm, q, D, T, H, B, sd[2], sd[1], sd[0], DKV_BM);
  if (!err)
    err = sm90::make_map(&km, k, D, S, KV, B, sd[5], sd[4], sd[3], DKV_BN);
  if (!err)
    err = sm90::make_map(&vm, v, D, S, KV, B, sd[8], sd[7], sd[6], DKV_BN);
  if (!err)
    err = sm90::make_map(&dm, d, D, T, H, B, sd[11], sd[10], sd[9], DKV_BM);
  if (!err) err = sm90::make_map_f32(&lm, lse, (int64_t)B * H * T, DKV_ROWS);
  if (!err) err = sm90::make_map_f32(&ddm, dd, (int64_t)B * H * T, DKV_ROWS);
  if (err) return err;
  constexpr int bytes = DkvSmem<D>::BYTES;
  const cudaError_t e = sm90::smem_opt_in<flash_bwd_dkv_kernel<D>>(bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(KV, B, (S + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, bytes, st>>>(
      qm, km, vm, dm, lm, ddm, dk, dv, lengths, H, KV, T, S, sd[12], sd[13],
      sd[14], sd[15], sd[16], sd[17], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return a cudaError_t as int (0 = launched). Strides are
// in elements: those of the b, head and token dims of each operand.
// lse and dd (= delta - dlse) are contiguous fp32 [B, H, T].
extern "C" int mm_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dd, void* dq, const int* lengths, int B,
    int H, int KV, int T, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t d_sb, int64_t d_sh, int64_t d_st,
    int64_t g_sb, int64_t g_sh, int64_t g_st,
    float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T <= 0 || S <= 0 ||
      B > 65535 || (T + DQ_BM - 1) / DQ_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t sd[15] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh,
                          v_st, d_sb, d_sh, d_st, g_sb, g_sh, g_st};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bf16* gp = static_cast<bf16*>(dq);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, dd, gp, lengths, B, H, KV, T,
                          S, sd, scale, causal, st);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, dd, gp, lengths, B, H, KV, T, S,
                         sd, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mm_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dd, void* dk, void* dv,
    const int* lengths, int B, int H, int KV, int T, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t d_sb, int64_t d_sh, int64_t d_st,
    int64_t gk_sb, int64_t gk_sh, int64_t gk_st,
    int64_t gv_sb, int64_t gv_sh, int64_t gv_st,
    float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t sd[18] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                          v_sb, v_sh, v_st, d_sb, d_sh, d_st,
                          gk_sb, gk_sh, gk_st, gv_sb, gv_sh, gv_st};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  if (B > 65535 || KV > 65535 || (S + DKV_BN - 1) / DKV_BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, dd, dkp, dvp, lengths, B, H,
                           KV, T, S, sd, scale, causal, st);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, dd, dkp, dvp, lengths, B, H,
                          KV, T, S, sd, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
