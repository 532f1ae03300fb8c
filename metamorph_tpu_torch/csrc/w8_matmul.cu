// Weight-only int8 matrix product for Hopper (sm_90a), kernel F:
//   out[M, N] = bf16((x[M, K] . q[N, K]^T) * scale[N])
// x bf16, q int8 (one row of K per output channel, K contiguous), scale
// fp32, products summed in fp32, the output rounded to bf16 once.
//
// Replaces: no Pallas kernel. `quantized_matmul` of
//   metamorph_tpu/ops/quant.py leaves the int8 -> bf16 convert to XLA:TPU,
//   which fuses it into the dot, so the dequantized matrix never reaches
//   device memory. This kernel is that fusion on the card: the int8 weight
//   is read once and converted in registers.
//
// What bounds it on the H100: in decode (M <= 32 rows) every weight byte is
// used for at most 2 * 32 operations, far below the card's ~295 operations
// per byte: the int8 bytes are the limit (half of bf16's). Large M (prefill
// buckets, the fill step's 8 + 256 rows) is bound by the tensor cores.
//
// The int8 -> bf16 convert is exact (|q| <= 127), so the kernel and its
// plain version differ only in the order of the fp32 sums.
//
// Both forms use `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) with the
// product's depth permuted inside each block of k: a lane's fragment
// registers then come from contiguous bytes (4 int8 weights, 4 bf16
// activations per k16 step) instead of 2-byte pairs, and since A and B
// use the same permutation the sum is unchanged.
//
//   * the "gemv" form (M <= 32, the decode and verify steps): the weight is
//     the A operand (16 output channels per warp), the activations the B
//     operand (8 rows per n8 tile, 1, 2 or 4 tiles). Each lane streams 16
//     bytes of two weight rows per 64-deep step straight into registers
//     (`ld.global.cs`: read once, kept out of L1), four steps in flight;
//     the activations (at most 32 x K bf16) come from L1/L2. The grid is
//     (N / 64, k splits): the host sizes the split from N and the SM count
//     so that a narrow product (wk, wv: N = 1,024) still covers the card.
//     Each CTA writes an fp32 partial; the last CTA of an output tile to
//     arrive (an arrival counter) sums the partials in split order, applies
//     the scale and writes bf16, then resets the counter: repeats are
//     bitwise equal and no second kernel is launched;
//   * the "tiled" form (M > 32): 128 x 128 output tiles, 8 warps of 64 x 32,
//     32-deep k steps through a 3-stage cp.async ring of the activation
//     tile (bf16) and the weight tile (int8, converted when its B fragments
//     are built), the scale applied in the epilogue. Rows and columns past
//     M and N arrive as zeros and are not written.
// K must be a multiple of 16 (every 16-byte load then lies inside a row).

#include "sm90.cuh"

namespace {

using sm90::bf16;

constexpr int NT = 128;            // gemv: threads per CTA (4 warps)
constexpr int G_BN = 64;           // gemv: output channels per CTA
constexpr int G_BK = 64;           // gemv: depth per step
constexpr int G_UNROLL = 4;        // gemv: steps in flight per lane
constexpr int T_NT = 256;          // tiled: threads per CTA (8 warps)
constexpr int T_BM = 128, T_BN = 128, T_BK = 32;
constexpr int T_STAGES = 3;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four int8 (one word, lowest byte first) -> two bf16x2 words:
// lo = (v0, v1), hi = (v2, v3), exactly
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  float f[4];
  sm90::i8x4_to_f32(w, f);
  lo = sm90::pack_bf16_exact(f[0], f[1]);
  hi = sm90::pack_bf16_exact(f[2], f[3]);
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------ gemv form
//
// Step (k0 .. k0 + 63): lane (g = lane / 4, t = lane % 4) holds the bytes
// k0 + 16t .. k0 + 16t + 15 of weight rows r and r + 8 (one uint4 each) and
// the same 16 activations of row g of each n8 tile (two uint4). mma j of
// the step uses depth k0 + 16t + 4j + 0..3 in the fragment slots
// (2t, 2t + 1, 2t + 8, 2t + 9): A = {row r (4j, 4j+1), row r+8 (4j, 4j+1),
// row r (4j+2, 4j+3), row r+8 (4j+2, 4j+3)}, B = {x (4j, 4j+1), x (4j+2,
// 4j+3)}. The accumulator of tile i: c0, c1 = channel r, activation rows
// 8i + 2t, 8i + 2t + 1; c2, c3 = channel r + 8, the same rows.
template <int NG>
__global__ void __launch_bounds__(NT) w8_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int N,
    int K, int split_len, float* __restrict__ ws, int* __restrict__ counters) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * G_BN;
  const int r = n0 + warp * 16 + g;                  // channels r, r + 8
  const int kb = blockIdx.y * split_len;
  const int ke = min(K, kb + split_len);
  const bool ra = r < N, rb = r + 8 < N;
  const int8_t* qa = q + (size_t)(ra ? r : 0) * K;
  const int8_t* qb = q + (size_t)(rb ? r + 8 : 0) * K;
  bool xrow[NG];
  const bf16* xp[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    xrow[i] = 8 * i + g < M;
    xp[i] = x + (size_t)(xrow[i] ? 8 * i + g : 0) * K;
  }
  float acc[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += G_BK * G_UNROLL) {
    uint4 wa[G_UNROLL], wb[G_UNROLL];
#pragma unroll
    for (int u = 0; u < G_UNROLL; ++u) {
      const int k = k0 + u * G_BK + 16 * t;
      const bool in = k < ke;
      wa[u] = (in && ra) ? __ldcs(reinterpret_cast<const uint4*>(qa + k))
                         : zero4();
      wb[u] = (in && rb) ? __ldcs(reinterpret_cast<const uint4*>(qb + k))
                         : zero4();
    }
#pragma unroll
    for (int u = 0; u < G_UNROLL; ++u) {
      const int k = k0 + u * G_BK + 16 * t;
      if (k0 + u * G_BK >= ke) break;          // uniform across the warp
      const bool in = k < ke;
      uint32_t a[4][4];                        // per mma j
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        i8x4_to_bf16x4(word(wa[u], j), a[j][0], a[j][2]);
        i8x4_to_bf16x4(word(wb[u], j), a[j][1], a[j][3]);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        uint4 x0 = zero4(), x1 = zero4();
        if (in && xrow[i]) {
          x0 = __ldg(reinterpret_cast<const uint4*>(xp[i] + k));
          x1 = __ldg(reinterpret_cast<const uint4*>(xp[i] + k + 8));
        }
        mma_16816(acc[i], a[0], x0.x, x0.y);
        mma_16816(acc[i], a[1], x0.z, x0.w);
        mma_16816(acc[i], a[2], x1.x, x1.y);
        mma_16816(acc[i], a[3], x1.z, x1.w);
      }
    }
  }

  const int ch_lo = warp * 16 + g;               // channel within the tile
  if (gridDim.y == 1) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = 8 * i + 2 * t + (c & 1);
        const int n = n0 + ch_lo + (c >> 1) * 8;
        if (m < M && n < N)
          out[(size_t)m * N + n] = __float2bfloat16(acc[i][c] * scale[n]);
      }
    return;
  }

  // k splits: this CTA's partial [8 * NG rows][G_BN channels], then the
  // last CTA of the tile sums all partials in split order
  constexpr int PART = 8 * NG * G_BN;
  float* part = ws + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * PART;
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = 8 * i + 2 * t + (c & 1);
      part[m * G_BN + ch_lo + (c >> 1) * 8] = acc[i][c];
    }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* tile = ws + (size_t)blockIdx.x * gridDim.y * PART;
  for (int idx = threadIdx.x; idx < PART; idx += NT) {
    const int m = idx / G_BN, n = n0 + idx % G_BN;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(tile + (size_t)sp * PART + idx);
    out[(size_t)m * N + n] = __float2bfloat16(s * scale[n]);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// ------------------------------------------------------------ tiled form
//
// Step (32 deep): lane (g, t) reads 8 bf16 activations (16 bytes) of rows g
// and g + 8 of each m16 tile and 8 int8 weights (8 bytes) of channel g of
// each n8 tile, all at depth 8t .. 8t + 7 of the step; mma j uses depth
// 8t + 4j + 0..3 (slots as in the gemv form, A and B swapped: A = x,
// B = q). The rows of both shared tiles are 64 and 32 bytes: a quarter
// warp's 16-byte reads and a half warp's 8-byte reads each cover 128
// contiguous bytes, so neither conflicts.
struct TiledSmem {
  bf16 x[T_STAGES][T_BM * T_BK];
  int8_t q[T_STAGES][T_BN * T_BK];
};

__global__ void __launch_bounds__(T_NT) w8_tiled_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int N,
    int K) {
  __shared__ __align__(128) TiledSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * T_BM, n0 = blockIdx.x * T_BN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;   // warp's sub-tile
  const int steps = (K + T_BK - 1) / T_BK;

  // loaders: x tile 128 rows x 4 chunks of 16 bytes (2 per thread), q tile
  // 128 rows x 2 chunks (1 per thread)
  auto load = [&](int stage, int step) {
    const int k = step * T_BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tid + h * T_NT;
      const int row = c / 4, col = (c % 4) * 8;
      const bool ok = m0 + row < M && k + col < K;
      const bf16* src = ok ? x + (size_t)(m0 + row) * K + k + col : x;
      sm90::cp_async16(&sm.x[stage][row * T_BK + col], src, ok);
    }
    {
      const int row = tid / 2, col = (tid % 2) * 16;
      const bool ok = n0 + row < N && k + col < K;
      const int8_t* src = ok ? q + (size_t)(n0 + row) * K + k + col : q;
      sm90::cp_async16(&sm.q[stage][row * T_BK + col], src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    sm90::cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    sm90::cp_wait<T_STAGES - 2>();
    __syncthreads();
    const int nxt = step + T_STAGES - 1;
    if (nxt < steps) load(nxt % T_STAGES, nxt);
    sm90::cp_commit();
    const int st = step % T_STAGES;
    uint32_t b[4][4];                  // n8 tile j: {b0, b1} for mma 0, 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 w = *reinterpret_cast<const uint2*>(
          &sm.q[st][(wn + 8 * j + g) * T_BK + 8 * t]);
      i8x4_to_bf16x4(w.x, b[j][0], b[j][1]);
      i8x4_to_bf16x4(w.y, b[j][2], b[j][3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 lo = *reinterpret_cast<const uint4*>(
          &sm.x[st][(wm + 16 * i + g) * T_BK + 8 * t]);
      const uint4 hi = *reinterpret_cast<const uint4*>(
          &sm.x[st][(wm + 16 * i + g + 8) * T_BK + 8 * t]);
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_16816(acc[i][j], a0, b[j][0], b[j][1]);
        mma_16816(acc[i][j], a1, b[j][2], b[j][3]);
      }
    }
  }

  // epilogue: c0, c1 = row g, channels 2t, 2t + 1; c2, c3 = row g + 8
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    if (n >= N) continue;
    const float s0 = scale[n], s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        bf16* o = out + (size_t)m * N + n;
        const float v0 = acc[i][j][2 * h] * s0;
        const float v1 = acc[i][j][2 * h + 1] * s1;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (n + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

}  // namespace

// x [M, K] bf16, q [N, K] int8 and out [M, N] bf16, all contiguous; scale
// fp32 [N]; K a multiple of 16, x and q 16-byte aligned.
// form 0 = gemv (M <= 32): grid (ceil(N / 64), n_split), k splits of
// split_len (a multiple of 64, split_len * n_split >= K). With n_split > 1,
// ws holds ceil(N / 64) * n_split * 8 * NG * 64 floats (NG = 1, 2, 4 for
// M <= 8, 16, 32) and counters ceil(N / 64) ints, zero before the first
// launch (each launch leaves them zero).
// form 1 = tiled (any M); split_len, n_split, ws and counters unused.
// Returns a cudaError_t as int (0 = launched).
extern "C" int mm_w8_matmul(const void* x, const void* q, const float* scale,
                            void* out, int M, int N, int K, int form,
                            int split_len, int n_split, float* ws,
                            int* counters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  bf16* op = static_cast<bf16*>(out);
  if (form == 1) {
    const dim3 grid((N + T_BN - 1) / T_BN, (M + T_BM - 1) / T_BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    w8_tiled_kernel<<<grid, T_NT, 0, st>>>(xp, qp, scale, op, M, N, K);
    return (int)cudaGetLastError();
  }
  if (form != 0 || M > 32 || split_len <= 0 || split_len % G_BK != 0 ||
      n_split <= 0 || n_split > 65535 ||
      (int64_t)split_len * n_split < K ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + G_BN - 1) / G_BN, n_split);
  if (M <= 8)
    w8_gemv_kernel<1><<<grid, NT, 0, st>>>(xp, qp, scale, op, M, N, K,
                                           split_len, ws, counters);
  else if (M <= 16)
    w8_gemv_kernel<2><<<grid, NT, 0, st>>>(xp, qp, scale, op, M, N, K,
                                           split_len, ws, counters);
  else
    w8_gemv_kernel<4><<<grid, NT, 0, st>>>(xp, qp, scale, op, M, N, K,
                                           split_len, ws, counters);
  return (int)cudaGetLastError();
}
