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
// with `mma.sync.m16n8k16` bf16 -> fp32 (the simple first step; wgmma, TMA
// and pipelining are later work), and the softmax never leaves registers.
//   * Kernel C: one CTA per (batch row, q head, 64-row q tile); four warps
//     own 16 q rows each and keep Q and dO as A fragments in registers. K/V
//     tiles of 64 keys are staged in padded shared memory (row stride Dh+8,
//     conflict-free fragment reads); the key loop ends at min(length,
//     causal end), as kernel A's does. dS leaves the score registers as the
//     A operand of dS K directly (the m16n8 accumulator layout is the
//     m16n8k16 A layout), rounded to bf16.
//   * Kernel D: one CTA per (batch row, kv head, 64-key tile); warp w owns
//     keys 16w..16w+15. K and V stay in shared memory; the CTA loops over
//     the G = H/KV q heads of its group and, for each, over the q tiles from
//     the first that can see the key tile (causal) to the end, staging Q,
//     dO, lse and delta of each in shared memory. It computes the
//     TRANSPOSED tiles S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//     out of the accumulators already in the A layout that dV += P^T dO and
//     dK += dS^T Q need — no transposed operand is ever loaded. dK and dV
//     stay in fp32 registers across the whole group and are written once.
//
// Semantics held to the Pallas kernels: key j is visible to query row i iff
// j < length[b] and (not causal or j <= i). P = exp(S*scale - lse) with the
// scale applied in fp32 to the fp32 scores; the mask is applied before the
// exp, so a row with no visible key (lse = -1e30) contributes nothing and
// gets dq = 0. dS = P * (dP - dd) * scale with dd = delta - dlse (the lse
// cotangent, zero when the lse was not used). Inputs and outputs are
// addressed through strides, so the model layout [B, T, H, Dh] needs no
// copies. No atomics: two launches on the same inputs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NWARPS = 4;     // 16 rows (kernel C) or 16 keys (kernel D) each
constexpr float LOG2E = 1.44269504088896340736f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, first value in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (D + 8) * 2 + 2 * BM * 4;
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ lengths,
                     int H, int KV, int T, int S,
                     int64_t q_sb, int64_t q_sh, int64_t q_st,
                     int64_t k_sb, int64_t k_sh, int64_t k_st,
                     int64_t v_sb, int64_t v_sh, int64_t v_st,
                     int64_t d_sb, int64_t d_sh, int64_t d_st,
                     int64_t gk_sb, int64_t gk_sh, int64_t gk_st,
                     int64_t gv_sb, int64_t gv_sh, int64_t gv_st,
                     float scale, int causal) {
  constexpr int KC = D / 16;
  constexpr int NTO = D / 8;
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BN * LDS;
  bf16* qs = vs + BN * LDS;
  bf16* ds = qs + BM * LDS;     // the dO tile
  float* lse_s = reinterpret_cast<float*>(ds + BM * LDS);
  float* dd_s = lse_s + BM;

  const int j0 = blockIdx.x * BN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const int length = max(0, min(lengths[b], S));
  const int key0 = j0 + warp * 16 + g;   // this thread's two keys
  const int key1 = key0 + 8;
  const float scale_log2 = scale * LOG2E;

  float dka[NTO][4], dva[NTO][4];
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }

  if (j0 < length) {           // a key tile past the length gets zeros
    stage_tile<D>(ks, k + b * k_sb + kvh * k_sh, k_st, j0, length);
    stage_tile<D>(vs, v + b * v_sb + kvh * v_sh, v_st, j0, length);
    const int i_begin = causal ? (j0 / BM) * BM : 0;
    const bf16* ka = ks + (warp * 16 + g) * LDS + tig * 2;
    const bf16* va = vs + (warp * 16 + g) * LDS + tig * 2;

    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const bf16* qb = q + b * q_sb + h * q_sh;
      const bf16* db = dout + b * d_sb + h * d_sh;
      const float* lrow = lse + ((int64_t)b * H + h) * T;
      const float* drow = dd + ((int64_t)b * H + h) * T;
      for (int i0 = i_begin; i0 < T; i0 += BM) {
        __syncthreads();        // the previous q tile is fully consumed
        stage_tile<D>(qs, qb, q_st, i0, T);
        stage_tile<D>(ds, db, d_st, i0, T);
        for (int r = threadIdx.x; r < BM; r += NWARPS * 32) {
          lse_s[r] = i0 + r < T ? lrow[i0 + r] * LOG2E : 0.f;
          dd_s[r] = i0 + r < T ? drow[i0 + r] : 0.f;
        }
        __syncthreads();

#pragma unroll 1
        for (int c16 = 0; c16 < BM / 16; ++c16) {   // 16 q rows at a time
          // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 q rows
          float st[2][4], dpt[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
            dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
          }
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            uint32_t af[4], vf[4];
            af[0] = ld32(ka + kc * 16);
            af[1] = ld32(ka + 8 * LDS + kc * 16);
            af[2] = ld32(ka + kc * 16 + 8);
            af[3] = ld32(ka + 8 * LDS + kc * 16 + 8);
            vf[0] = ld32(va + kc * 16);
            vf[1] = ld32(va + 8 * LDS + kc * 16);
            vf[2] = ld32(va + kc * 16 + 8);
            vf[3] = ld32(va + 8 * LDS + kc * 16 + 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int off = (c16 * 16 + j * 8 + g) * LDS + tig * 2 + kc * 16;
              mma_16816(st[j], af, ld32(qs + off), ld32(qs + off + 8));
              mma_16816(dpt[j], vf, ld32(ds + off), ld32(ds + off + 8));
            }
          }
          // P^T and dS^T; rows are keys, columns q rows
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = (e < 2) ? key0 : key1;
              const int rl = c16 * 16 + j * 8 + tig * 2 + (e & 1);
              const int qi = i0 + rl;
              const bool ok = key < length && qi < T && (!causal || key <= qi);
              const float p = ok ? exp2f(st[j][e] * scale_log2 - lse_s[rl]) : 0.f;
              st[j][e] = p;
              dpt[j][e] = p * (dpt[j][e] - dd_s[rl]) * scale;
            }
          }
          uint32_t pa[4], sa[4];
          pa[0] = pack_bf16(st[0][0], st[0][1]);
          pa[1] = pack_bf16(st[0][2], st[0][3]);
          pa[2] = pack_bf16(st[1][0], st[1][1]);
          pa[3] = pack_bf16(st[1][2], st[1][3]);
          sa[0] = pack_bf16(dpt[0][0], dpt[0][1]);
          sa[1] = pack_bf16(dpt[0][2], dpt[0][3]);
          sa[2] = pack_bf16(dpt[1][0], dpt[1][1]);
          sa[3] = pack_bf16(dpt[1][2], dpt[1][3]);
          // dV += P^T dO and dK += dS^T Q: depth = these 16 q rows
          const bf16* dop = ds + (c16 * 16 + tig * 2) * LDS + g;
          const bf16* qp = qs + (c16 * 16 + tig * 2) * LDS + g;
#pragma unroll
          for (int nt = 0; nt < NTO; ++nt) {
            uint32_t b0, b1;
            b_frag_kmajor(dop + nt * 8, LDS, b0, b1);
            mma_16816(dva[nt], pa, b0, b1);
            b_frag_kmajor(qp + nt * 8, LDS, b0, b1);
            mma_16816(dka[nt], sa, b0, b1);
          }
        }
      }
    }
  }

  bf16* kout = dk + b * gk_sb + kvh * gk_sh;
  bf16* vout = dv + b * gv_sb + kvh * gv_sh;
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(kout + key0 * gk_st + c) =
          pack_bf16(dka[nt][0], dka[nt][1]);
      *reinterpret_cast<uint32_t*>(vout + key0 * gv_st + c) =
          pack_bf16(dva[nt][0], dva[nt][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<uint32_t*>(kout + key1 * gk_st + c) =
          pack_bf16(dka[nt][2], dka[nt][3]);
      *reinterpret_cast<uint32_t*>(vout + key1 * gv_st + c) =
          pack_bf16(dva[nt][2], dva[nt][3]);
    }
  }
}

template <int D>
int launch_dkv(dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
               const bf16* v, const bf16* d, const float* lse,
               const float* dd, bf16* dk, bf16* dv, const int* lengths,
               int H, int KV, int T, int S, const int64_t* sd, float scale,
               int causal) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D><<<grid, NWARPS * 32, bytes, st>>>(
      q, k, v, d, lse, dd, dk, dv, lengths, H, KV, T, S, sd[0], sd[1], sd[2],
      sd[3], sd[4], sd[5], sd[6], sd[7], sd[8], sd[9], sd[10], sd[11], sd[12],
      sd[13], sd[14], sd[15], sd[16], sd[17], scale, causal);
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
  const dim3 grid((S + BN - 1) / BN, KV, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int64_t sd[18] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                          v_sb, v_sh, v_st, d_sb, d_sh, d_st,
                          gk_sb, gk_sh, gk_st, gv_sb, gv_sh, gv_st};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  if (D == 128)
    return launch_dkv<128>(grid, st, qp, kp, vp, dp, lse, dd, dkp, dvp,
                           lengths, H, KV, T, S, sd, scale, causal);
  if (D == 64)
    return launch_dkv<64>(grid, st, qp, kp, vp, dp, lse, dd, dkp, dvp,
                          lengths, H, KV, T, S, sd, scale, causal);
  return (int)cudaErrorInvalidValue;
}
