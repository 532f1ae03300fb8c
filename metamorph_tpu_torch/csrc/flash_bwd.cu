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
// and the softmax never leaves registers.
//   * Kernel C (the first, simple design; `mma.sync.m16n8k16` bf16 -> fp32,
//     no pipelining): one CTA per (batch row, q head, 64-row q tile); four
//     warps own 16 q rows each and keep Q and dO as A fragments in
//     registers. K/V tiles of 64 keys are staged in padded shared memory
//     (row stride Dh+8, conflict-free fragment reads); the key loop ends at
//     min(length, causal end), as kernel A's does. dS leaves the score
//     registers as the A operand of dS K directly (the m16n8 accumulator
//     layout is the m16n8k16 A layout), rounded to bf16.
//   * Kernel D (Hopper design, helpers in sm90.cuh): one CTA per (kv head,
//     batch row, 128-key tile), key tile 0 (the heaviest when causal)
//     launched first. Two consumer warpgroups own 64 keys each; one thread
//     of a producer warpgroup issues the TMA loads, and `setmaxnreg` moves
//     registers from the producer (24) to the consumers (240). K and V are
//     loaded once; the producer then streams (Q, dO) tiles of 64 q rows,
//     with their lse and delta rows, of every q head of the group — from
//     the first q tile that can see the key tile (causal) to the end —
//     through a 2-stage ring of shared-memory stages guarded by full/empty
//     mbarriers, so loads overlap the math. Per tile, S^T = K Q^T and
//     dP^T = V dO^T are wgmma m64n64k16 from shared memory (all K-major);
//     P^T and dS^T come out of those accumulators already in the register
//     A layout of dV += P^T dO and dK += dS^T Q, which are wgmma with dO
//     and Q read as MN-major (transposed) B operands. Only tiles that cross
//     the diagonal, the length or T are masked. dK and dV stay in fp32
//     registers across the whole group and are written once.
//
// Semantics held to the Pallas kernels: key j is visible to query row i iff
// j < length[b] and (not causal or j <= i). P = exp(S*scale - lse) with the
// scale applied in fp32 to the fp32 scores; the mask is applied before the
// exp, so a row with no visible key (lse = -1e30) contributes nothing and
// gets dq = 0. dS = P * (dP - dd) * scale with dd = delta - dlse (the lse
// cotangent, zero when the lse was not used). Inputs and outputs are
// addressed through strides, so the model layout [B, T, H, Dh] needs no
// copies. No atomics: two launches on the same inputs give equal bits.

#include "sm90.cuh"

namespace {

using sm90::bf16;
using sm90::pack_bf16;

constexpr int BM = 64;        // kernel C: q rows per CTA
constexpr int BN = 64;        // kernel C: keys per tile
constexpr int NWARPS = 4;     // kernel C: 16 q rows each
constexpr float LOG2E = 1.44269504088896340736f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 -> bf16x2, first value in the low half
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of a [k=16 rows, n=8 cols] slice of a row-major smem tile
// whose rows are the product's depth: two k-consecutive values of column g.
__device__ __forceinline__ void b_frag_kmajor(const bf16* p, int lds,
                                              uint32_t& b0, uint32_t& b1) {
  b0 = pack_bf16(p[0], p[lds]);
  b1 = pack_bf16(p[8 * lds], p[9 * lds]);
}

// rows [r0, r0 + 64) of a [rows, D] strided bf16 matrix into a padded smem
// tile; rows at or past `end` are zero
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int64_t stride, int r0, int end) {
  constexpr int LDS = D + 8;
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += NWARPS * 32) {
    const int r = i / VPR;
    const int cv = (i % VPR) * 8;
    uint4 vec = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < end)
      vec = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + cv);
    *reinterpret_cast<uint4*>(dst + r * LDS + cv) = vec;
  }
}

// ---------------------------------------------------------------------------
// kernel C: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    const int* __restrict__ lengths, int H, int KV, int T,
                    int S, int64_t q_sb, int64_t q_sh, int64_t q_st,
                    int64_t k_sb, int64_t k_sh, int64_t k_st,
                    int64_t v_sb, int64_t v_sh, int64_t v_st,
                    int64_t d_sb, int64_t d_sh, int64_t d_st,
                    int64_t g_sb, int64_t g_sh, int64_t g_st,
                    float scale, int causal) {
  constexpr int KC = D / 16;    // 16-deep chunks of the head dim
  constexpr int NTO = D / 8;    // 8-wide n tiles of the head dim (dQ)
  constexpr int LDS = D + 8;
  __shared__ __align__(16) bf16 ks[BN * LDS];
  __shared__ __align__(16) bf16 vs[BN * LDS];

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const int length = max(0, min(lengths[b], S));
  const int kv_end = causal ? min(length, q0 + BM) : length;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* db = dout + b * d_sb + h * d_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  const int r0 = q0 + warp * 16 + g;   // this thread's two q rows
  const int r1 = r0 + 8;

  uint32_t qf[KC][4], df[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = r0 < T ? ld32(qb + r0 * q_st + c) : 0u;
    qf[kc][1] = r1 < T ? ld32(qb + r1 * q_st + c) : 0u;
    qf[kc][2] = r0 < T ? ld32(qb + r0 * q_st + c + 8) : 0u;
    qf[kc][3] = r1 < T ? ld32(qb + r1 * q_st + c + 8) : 0u;
    df[kc][0] = r0 < T ? ld32(db + r0 * d_st + c) : 0u;
    df[kc][1] = r1 < T ? ld32(db + r1 * d_st + c) : 0u;
    df[kc][2] = r0 < T ? ld32(db + r0 * d_st + c + 8) : 0u;
    df[kc][3] = r1 < T ? ld32(db + r1 * d_st + c + 8) : 0u;
  }
  const float* lrow = lse + ((int64_t)b * H + h) * T;
  const float* drow = dd + ((int64_t)b * H + h) * T;
  const float lse2[2] = {r0 < T ? lrow[r0] * LOG2E : 0.f,
                         r1 < T ? lrow[r1] * LOG2E : 0.f};
  const float ddr[2] = {r0 < T ? drow[r0] : 0.f, r1 < T ? drow[r1] : 0.f};
  const float scale_log2 = scale * LOG2E;

  float acc[NTO][4];
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();            // the previous tile is fully consumed
    stage_tile<D>(ks, kb, k_st, k0, kv_end);
    stage_tile<D>(vs, vb, v_st, k0, kv_end);
    __syncthreads();

#pragma unroll
    for (int c16 = 0; c16 < BN / 16; ++c16) {   // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        const int off = ((c16 * 2 + j) * 8 + g) * LDS + tig * 2;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          mma_16816(s[j], qf[kc], ld32(ks + off + kc * 16),
                    ld32(ks + off + kc * 16 + 8));
          mma_16816(dp[j], df[kc], ld32(vs + off + kc * 16),
                    ld32(vs + off + kc * 16 + 8));
        }
      }
      // dS = P * (dP - dd) * scale, P masked before the exp
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (e < 2) ? r0 : r1;
          const int col = k0 + (c16 * 2 + j) * 8 + tig * 2 + (e & 1);
          const bool ok = col < length && (!causal || col <= row);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - ddr[e >> 1]) * scale;
        }
      }
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
      // dQ += dS K: depth = these 16 keys, n = head dim
      const bf16* kp = ks + (c16 * 16 + tig * 2) * LDS + g;
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt) {
        uint32_t b0, b1;
        b_frag_kmajor(kp + nt * 8, LDS, b0, b1);
        mma_16816(acc[nt], a, b0, b1);
      }
    }
  }

  bf16* gb = dq + b * g_sb + h * g_sh;
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(gb + r0 * g_st + c) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(gb + r1 * g_st + c) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
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
  static bool sized = false;   // once per instantiation and process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
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
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BM - 1) / BM, H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  bf16* gp = static_cast<bf16*>(dq);
  if (D == 128) {
    flash_bwd_dq_kernel<128><<<grid, NWARPS * 32, 0, st>>>(
        qp, kp, vp, dp, lse, dd, gp, lengths, H, KV, T, S, q_sb, q_sh, q_st,
        k_sb, k_sh, k_st, v_sb, v_sh, v_st, d_sb, d_sh, d_st, g_sb, g_sh,
        g_st, scale, causal);
  } else if (D == 64) {
    flash_bwd_dq_kernel<64><<<grid, NWARPS * 32, 0, st>>>(
        qp, kp, vp, dp, lse, dd, gp, lengths, H, KV, T, S, q_sb, q_sh, q_st,
        k_sb, k_sh, k_st, v_sb, v_sh, v_st, d_sb, d_sh, d_st, g_sb, g_sh,
        g_st, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
