// Chunk attention for Hopper (sm_90a), kernel E: NB chunks of C query
// tokens, chunk nb against ONE row rows[nb] of the stacked KV cache
// [L, B, KV, S, Dh] (bf16, or int8 with fp32 per-(token, kv head) scales
// [L, B, KV, S]), causal with an offset: chunk token c sees key j iff
// j <= offs[nb] + c. fp32 online softmax and accumulation, bf16 out.
//
// Replaces: the Pallas TPU kernels `_chunk_kernel` (driven by
//   `chunk_attention`: one prompt chunk of row `slot` at `chunk_off`, the
//   chunked-fill step) and `_chunk_kernel_batched` (driven by
//   `chunk_attention_batched`: every row's chunk against its own row at its
//   own offset, the speculative-verification step) of
//   metamorph_tpu/ops/decode_attention.py, bf16 and int8 branches. K6 is
//   NB = 1 with rows = [slot], K7 is NB = B with rows = 0..B-1. There is no
//   length and no start: entries past off + C - 1 may be stale (rejected
//   drafts, an earlier fill), and the mask alone keeps them out.
//
// Two kernels, chosen by the problem's packed query rows G*C (G = H / KV
// query heads per kv head; row i is chunk token i / G, head kvh*G + i % G,
// so every K/V tile serves all G heads and K/V are never repeated):
//   - G*C > 16, the fill form (C = 256, G*C = 1024 rows per key): the
//     tensor cores bound it. `chunk_fill.cu`: wgmma, TMA, a 2-stage ring
//     under mbarriers, a producer warp, key splits merged in the launch;
//   - G*C <= 16, the verify form (C = spec_k = 4, G = 4: 16 rows per key,
//     ~16 FLOP per byte): HBM bytes bound it. This file's kernel: one
//     four-warp CTA per (chunk, kv head) runs `mma.sync.m16n8k16` on the 16
//     rows; the warps split each 64-key tile into four 16-key slices, each
//     with its own online softmax state, merged through shared memory at
//     the end. Tiles are staged through registers between __syncthreads;
//     the CTA loops only up to off + c_max, so stale cache beyond costs
//     nothing.
// int8 (this kernel): K/V convert to bf16 on the way into shared memory
// (exact for |v| <= 127); k_scale multiplies the fp32 score, v_scale
// multiplies P before its bf16 rounding, and the softmax sum takes the
// unscaled P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;        // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// 16 bytes of cache row (8 bf16 or 16 int8 values) -> bf16 in shared memory
template <typename T>
__device__ __forceinline__ void stage16(bf16* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 1) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (ok) raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = pack_bf16(static_cast<float>(e[2 * j]),
                       static_cast<float>(e[2 * j + 1]));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (ok) raw = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NWARPS * 32)
chunk_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs, bf16* __restrict__ o,
                  const int* __restrict__ rows, const int* __restrict__ offs,
                  int C, int H, int KV, int S, int64_t layer_off,
                  int64_t c_sb, int64_t c_sh, int64_t sc_layer_off,
                  int64_t sc_sb, int64_t sc_sh, float scale_log2) {
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int WQ = 1;            // 16-row query groups per CTA
  constexpr int WK = NWARPS / WQ;  // key slices per tile
  constexpr int KW = BN / WK;      // keys per warp per tile
  constexpr int BM = 16 * WQ;      // query rows per CTA
  constexpr int KC = D / 16;       // 16-wide chunks of the head dim
  constexpr int NTO = D / 8;       // 8-wide n tiles of the head dim
  constexpr int NTS = KW / 8;      // 8-wide n tiles of a warp's key slice
  constexpr int LDS = D + 8;       // padded shared-memory row stride
  constexpr int EPV = 16 / sizeof(T);  // cache elements per 16-byte vector
  constexpr int VPR = D / EPV;         // 16-byte vectors per cache row
  // the K/V tiles during the loop; the per-warp partial outputs after it
  constexpr int TILE_BYTES = 2 * BN * LDS * 2;
  constexpr int RED_BYTES = NWARPS * 16 * D * 4;
  __shared__ __align__(16) unsigned char smem[
      TILE_BYTES > RED_BYTES ? TILE_BYTES : RED_BYTES];
  __shared__ float ksc_s[BN], vsc_s[BN];
  __shared__ float red_m[NWARPS][16], red_l[NWARPS][16];
  bf16* ks_t = reinterpret_cast<bf16*>(smem);
  bf16* vs_t = ks_t + BN * LDS;
  float* red_o = reinterpret_cast<float*>(smem);

  const int G = H / KV;
  const int GC = G * C;
  const int r_cta = blockIdx.x * BM;
  const int kvh = blockIdx.y;
  const int nb = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int qgrp = warp % WQ;      // this warp's 16 query rows
  const int kslc = warp / WQ;      // this warp's key slice of each tile

  const int row = rows[nb];
  const int off = offs[nb];
  const int r_last = min(r_cta + BM, GC) - 1;
  const int kv_end = min(S, off + r_last / G + 1);

  const T* kb = kc + layer_off + row * c_sb + kvh * c_sh;
  const T* vb = vc + layer_off + row * c_sb + kvh * c_sh;
  const int64_t sc_off = sc_layer_off + row * sc_sb + kvh * sc_sh;

  // query row i -> (chunk token i / G, head kvh * G + i % G)
  const int r0 = r_cta + qgrp * 16 + g;
  const int r1 = r0 + 8;
  const int lim0 = off + r0 / G;   // last key row r0 may see
  const int lim1 = off + r1 / G;
  auto qrow = [&](int r) {
    return q + (((int64_t)nb * C + r / G) * H + kvh * G + r % G) * D;
  };
  const bf16* q0p = qrow(r0 < GC ? r0 : 0);
  const bf16* q1p = qrow(r1 < GC ? r1 : 0);
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = r0 < GC ? ld32(q0p + c) : 0u;
    qf[kc][1] = r1 < GC ? ld32(q1p + c) : 0u;
    qf[kc][2] = r0 < GC ? ld32(q0p + c + 8) : 0u;
    qf[kc][3] = r1 < GC ? ld32(q1p + c + 8) : 0u;
  }

  float oacc[NTO][4];
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt)
    oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};         // partial row sums over this thread's cols

  const int kbase = kslc * KW;     // the warp's slice within a tile
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();               // the previous tile is fully consumed
    for (int i = threadIdx.x; i < BN * VPR; i += NWARPS * 32) {
      const int r = i / VPR;
      const int cv = (i % VPR) * EPV;
      const int key = k0 + r;
      const bool ok = key < kv_end;  // zero-fill: masked p times 0 stays 0
      stage16<T>(ks_t + r * LDS + cv, kb + (int64_t)key * D + cv, ok);
      stage16<T>(vs_t + r * LDS + cv, vb + (int64_t)key * D + cv, ok);
    }
    if constexpr (Q8) {
      for (int i = threadIdx.x; i < BN; i += NWARPS * 32) {
        const bool ok = k0 + i < kv_end;
        ksc_s[i] = ok ? ks[sc_off + k0 + i] : 0.f;
        vsc_s[i] = ok ? vs[sc_off + k0 + i] : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x its KW keys
    float s[NTS][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = ks_t + (kbase + nt * 8 + g) * LDS + tig * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_16816(s[nt], qf[kc], ld32(krow + kc * 16),
                  ld32(krow + kc * 16 + 8));
    }

    // scale (fp32, log2 domain; k_scale for int8), mask, tile row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kbase + nt * 8 + tig * 2 + (e & 1);
        const int col = k0 + j;
        const bool ok = col < kv_end && col <= ((e < 2) ? lim0 : lim1);
        const float sc = Q8 ? scale_log2 * ksc_s[j] : scale_log2;
        s[nt][e] = ok ? s[nt][e] * sc : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (s[nt][e] == NEG_INF) ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = Q8 ? p * vsc_s[kbase + nt * 8 + tig * 2 + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      oacc[nt][0] *= alpha[0];
      oacc[nt][1] *= alpha[0];
      oacc[nt][2] *= alpha[1];
      oacc[nt][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A-operand layout
#pragma unroll
    for (int kc = 0; kc < KW / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* vrow = vs_t + (kbase + kc * 16 + tig * 2) * LDS + g;
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt) {
        const bf16* vp = vrow + nt * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LDS]);
        const uint32_t b1 = pack_bf16(vp[8 * LDS], vp[9 * LDS]);
        mma_16816(oacc[nt], pa, b0, b1);
      }
    }
  }

  // merge: each warp parks its rows' (m, l, unnormalised O) in shared
  // memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();                 // the K/V tiles are dead
  float* ob_w = red_o + warp * 16 * D;
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt) {
    const int c = nt * 8 + tig * 2;
    ob_w[g * D + c] = oacc[nt][0];
    ob_w[g * D + c + 1] = oacc[nt][1];
    ob_w[(g + 8) * D + c] = oacc[nt][2];
    ob_w[(g + 8) * D + c + 1] = oacc[nt][3];
  }
  if (tig == 0) {
    red_m[warp][g] = m[0];
    red_l[warp][g] = l[0];
    red_m[warp][g + 8] = m[1];
    red_l[warp][g + 8] = l[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += NWARPS * 32) {
    const int rl = i / D;          // row within the CTA
    const int d = i % D;
    const int r = r_cta + rl;
    if (r >= GC) continue;
    const int qg = rl / 16;
    const int rr = rl % 16;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, red_m[w * WQ + qg][rr]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const int wi = w * WQ + qg;
      const float f = exp2f(red_m[wi][rr] - M);
      L += red_l[wi][rr] * f;
      O += red_o[(wi * 16 + rr) * D + d] * f;
    }
    o[(((int64_t)nb * C + r / G) * H + kvh * G + r % G) * D + d] =
        __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

template <int D, typename T>
int launch_verify(int NB, int C, int H, int KV, cudaStream_t st,
                  const bf16* q, const T* kc, const T* vc, const float* ks,
                  const float* vs, bf16* o, const int* rows, const int* offs,
                  int S, int64_t layer_off, int64_t c_sb, int64_t c_sh,
                  int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
                  float scale_log2) {
  const dim3 grid(((H / KV) * C + 15) / 16, KV, NB);
  chunk_attn_kernel<D, T><<<grid, NWARPS * 32, 0, st>>>(
      q, kc, vc, ks, vs, o, rows, offs, C, H, KV, S, layer_off, c_sb, c_sh,
      sc_layer_off, sc_sb, sc_sh, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int verify(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* rows, const int* offs,
           int NB, int C, int H, int KV, int S, int D, int64_t layer_off,
           int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
           int64_t sc_sh, float scale_log2, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_verify<128, T>(NB, C, H, KV, st, qp, kp, vp, ks, vs, op,
                                 rows, offs, S, layer_off, c_sb, c_sh,
                                 sc_layer_off, sc_sb, sc_sh, scale_log2);
  if (D == 64)
    return launch_verify<64, T>(NB, C, H, KV, st, qp, kp, vp, ks, vs, op,
                                rows, offs, S, layer_off, c_sb, c_sh,
                                sc_layer_off, sc_sb, sc_sh, scale_log2);
  return (int)cudaErrorInvalidValue;
}

bool bad_args(int NB, int C, int H, int KV, int S) {
  return NB <= 0 || C <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0;
}

constexpr float LOG2E = 1.44269504088896340736f;

}  // namespace

// defined in chunk_fill.cu: the fill form (more than 16 packed rows)
int mm_chunk_fill_bf16(const void* q, const void* k, const void* v, void* o,
                       const int* rows, const int* offs, int NB, int C, int H,
                       int KV, int S, int D, int Bc, int64_t layer_off,
                       int64_t c_sb, int64_t c_sh, float scale_log2,
                       int n_split, float* ws, int* counters, void* stream);
int mm_chunk_fill_int8(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale, void* o,
                       const int* rows, const int* offs, int NB, int C, int H,
                       int KV, int S, int D, int Bc, int64_t layer_off,
                       int64_t c_sb, int64_t c_sh, int64_t sc_layer_off,
                       int64_t sc_sb, int64_t sc_sh, float scale_log2,
                       int n_split, float* ws, int* counters, void* stream);

// q and o [NB, C, H, D] contiguous; k/v the stacked cache with rows of D
// contiguous elements, `layer_off` the element offset of the layer's
// [Bc, KV, S, D] block and c_sb / c_sh its row / kv-head strides; rows and
// offs [NB] int32 on the device. The fill form splits each CTA's keys into
// n_split parts merged through ws / counters (see chunk_fill.cu; the
// verify form uses neither). Returns a cudaError_t as int (0 = launched).
extern "C" int mm_chunk_attn_bf16(
    const void* q, const void* k, const void* v, void* o, const int* rows,
    const int* offs, int NB, int C, int H, int KV, int S, int D, int Bc,
    int64_t layer_off, int64_t c_sb, int64_t c_sh, float scale, int n_split,
    float* ws, int* counters, void* stream) {
  if (bad_args(NB, C, H, KV, S)) return (int)cudaErrorInvalidValue;
  if ((H / KV) * C > 16)
    return mm_chunk_fill_bf16(q, k, v, o, rows, offs, NB, C, H, KV, S, D, Bc,
                              layer_off, c_sb, c_sh, scale * LOG2E, n_split,
                              ws, counters, stream);
  return verify<bf16>(q, k, v, nullptr, nullptr, o, rows, offs, NB, C, H, KV,
                      S, D, layer_off, c_sb, c_sh, 0, 0, 0, scale * LOG2E,
                      stream);
}

// The int8 cache: k/v int8 as above; k_scale/v_scale fp32 planes with one
// value per (token, kv head), `sc_layer_off` / `sc_sb` / `sc_sh` their layer
// offset and row / kv-head strides (elements; the token stride is 1).
extern "C" int mm_chunk_attn_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* o, const int* rows, const int* offs, int NB,
    int C, int H, int KV, int S, int D, int Bc, int64_t layer_off,
    int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
    int64_t sc_sh, float scale, int n_split, float* ws, int* counters,
    void* stream) {
  if (bad_args(NB, C, H, KV, S)) return (int)cudaErrorInvalidValue;
  if ((H / KV) * C > 16)
    return mm_chunk_fill_int8(q, k, v, k_scale, v_scale, o, rows, offs, NB, C,
                              H, KV, S, D, Bc, layer_off, c_sb, c_sh,
                              sc_layer_off, sc_sb, sc_sh, scale * LOG2E,
                              n_split, ws, counters, stream);
  return verify<int8_t>(q, k, v, k_scale, v_scale, o, rows, offs, NB, C, H,
                        KV, S, D, layer_off, c_sb, c_sh, sc_layer_off, sc_sb,
                        sc_sh, scale * LOG2E, stream);
}
