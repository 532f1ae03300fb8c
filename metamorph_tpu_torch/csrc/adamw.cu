// AdamW over the optimizer state in two passes, kernel H:
//   1. adamw_sumsq_kernel: each trainable gradient read once, one fp32 sum
//      of squares per work block (adamw_reduce_kernel then sums each norm
//      group's blocks in a fixed order);
//   2. adamw_update_kernel: g, p, mu and nu read once, the clip, both
//      moments, Adam's update and the weight decay in fp32 registers, and
//      p, mu and nu written once, each rounded to its own dtype.
//
// Replaces: no Pallas kernel. The JAX package's optimizer is an optax chain
//   (metamorph_tpu/train/optimizer.py `make_optimizer`) that XLA fuses into
//   a few passes over the state. The port's plain version
//   (train/optimizer.py `adamw_chunk_` and `AdamW.global_norm`) runs the
//   same chain as ~25 separate PyTorch kernels per 64 M-element chunk, each
//   with fp32 temporaries in device memory: ~220 bytes of traffic per bf16
//   parameter where the step needs 16.
//
// What bounds it: bytes. Per parameter the update does ~20 fp32 operations
// on 14 bytes (bf16 g, p, mu, nu in; p, mu, nu out), and the norm pass 2 on
// 2 bytes: far below the card's ~295 operations per byte. The design keeps
// every byte in flight and touches it once:
//   * one launch per pass over all trainable tensors: a table in device
//     memory (one 64-byte entry per tensor: pointers, numel, its first work
//     block, the group's lr, the norm group) that the host builds each step
//     (gradients are reallocated every step), copied once without a sync.
//     A persistent grid walks the table's work blocks of 8,192 elements
//     (grid stride; each CTA advances a cursor through the table), so no
//     launch is per tensor or per chunk. Offsets are 64-bit;
//   * 16-byte loads and stores (8 bf16 or 4 fp32 lanes), cache-streaming,
//     four vectors per thread (two with fp32 state) issued before any
//     arithmetic; a tensor's tail block, or a tensor not 16-byte aligned,
//     goes element by element;
//   * the norm: per-block fp32 partials (fixed warp and block trees), then
//     one CTA per norm group sums its blocks in table order in fp64. No
//     float atomics, so repeats are bitwise equal. The host all-reduces
//     each group's sum (sharded steps) and takes the sqrt; the update pass
//     reads the norm from device memory and applies the masked clip, so the
//     host never waits for the card.
// The arithmetic is the plain chain's, operation by operation and rounding
// by rounding: explicit __f*_rn intrinsics (no contraction into FMA), and a
// multiplication by the bias corrections' reciprocals (taken in fp64 on the
// host, then rounded to fp32), which is how PyTorch divides a CUDA tensor
// by a host scalar. So the update is bitwise the plain chain's on the card
// for the same norm.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                          // elements per vector
constexpr int kItems = 4;                        // vectors per thread
constexpr int kBlock = kThreads * kVec * kItems; // 8,192 elements
constexpr int kReduceThreads = 1024;

typedef __nv_bfloat16 bf16;

// One trainable tensor (or one offloaded chunk). Layout shared with
// ops/adamw.py's ENTRY.
struct Entry {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  long long numel;
  long long blk;   // its first work block in the table's block space
  float lr;        // the group's lr at this step, as fp32
  int group;       // norm group index
  int g_bf16;      // the gradient's dtype for the norm pass (1 bf16, 0 fp32)
  int pad;
};
static_assert(sizeof(Entry) == 64, "Entry must match ops/adamw.py");

// Per-launch scalars, each the fp32 value PyTorch's kernels use: c1 = 1 - b1
// and c2 = 1 - b2 rounded from double, inv_bc1 = fp32(1 / (1 - b1^(t+1)))
// with the reciprocal in double.
struct Scalars {
  float c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd, max_norm;
  int has_wd;   // weight decay applied (the plain chain skips it at 0)
  int clip;     // 1: the masked global-norm clip, reading *norm
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements as loaded: one 16-byte vector of bf16, two of fp32
template <typename T> struct Raw;
template <> struct Raw<bf16> { uint4 a; };
template <> struct Raw<float> { float4 a, b; };

__device__ __forceinline__ void load_raw(const bf16* src, Raw<bf16>& r) {
  r.a = __ldcs(reinterpret_cast<const uint4*>(src));
}
__device__ __forceinline__ void load_raw(const float* src, Raw<float>& r) {
  const float4* s = reinterpret_cast<const float4*>(src);
  r.a = __ldcs(s);
  r.b = __ldcs(s + 1);
}

__device__ __forceinline__ void unpack(const Raw<bf16>& r,
                                       float (&out)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Raw<float>& r,
                                       float (&out)[kVec]) {
  out[0] = r.a.x; out[1] = r.a.y; out[2] = r.a.z; out[3] = r.a.w;
  out[4] = r.b.x; out[5] = r.b.y; out[6] = r.b.z; out[7] = r.b.w;
}

__device__ __forceinline__ void store8(bf16* dst, const float (&in)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(in[2 * i]),
                              __float2bfloat16_rn(in[2 * i + 1]));
  __stcs(reinterpret_cast<uint4*>(dst), raw);
}
__device__ __forceinline__ void store8(float* dst, const float (&in)[kVec]) {
  float4* d = reinterpret_cast<float4*>(dst);
  __stcs(d, make_float4(in[0], in[1], in[2], in[3]));
  __stcs(d + 1, make_float4(in[4], in[5], in[6], in[7]));
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// One element of the plain chain (train/optimizer.py), in its order:
//   g = where(norm >= max_norm, g / norm * max_norm, g)
//   m = (1 - b1) * g + b1 * mu;  v = (1 - b2) * g * g + b2 * nu
//   u = (m / bc1) / (sqrt(v / bc2) + eps);  u = u + wd * p  (wd != 0)
//   p = p - lr * u
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      float lr, const Scalars& s, bool clip,
                                      float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), s.max_norm);
  m = __fadd_rn(__fmul_rn(g, s.c1), __fmul_rn(m, s.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, s.c2), g), __fmul_rn(v, s.b2));
  float u = __fdiv_rn(__fmul_rn(m, s.inv_bc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps));
  if (s.has_wd) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  p = __fsub_rn(p, __fmul_rn(u, lr));
}

// Advances the CTA's cursor e to the entry holding work block b (entries
// sorted by blk, none empty; b only grows).
__device__ __forceinline__ int seek(const Entry* __restrict__ table, int e,
                                    int hi, long long b) {
  while (e + 1 < hi && __ldg(&table[e + 1].blk) <= b) ++e;
  return e;
}

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads, 2)
adamw_update_kernel(const Entry* __restrict__ table, int lo, int hi,
                    long long blk_lo, long long blk_hi, Scalars s,
                    const float* __restrict__ norm_ptr) {
  constexpr int kGroup =
      sizeof(TP) + sizeof(TG) + 2 * sizeof(TM) <= 8 ? kItems : kItems / 2;
  float norm = 0.f;
  bool clip = false;
  if (s.clip) {
    norm = *norm_ptr;
    clip = norm >= s.max_norm;
  }
  int e = lo;
  for (long long b = blk_lo + blockIdx.x; b < blk_hi; b += gridDim.x) {
    e = seek(table, e, hi, b);
    const Entry ent = table[e];
    const long long start = (b - ent.blk) * kBlock;
    const long long n = ent.numel - start;
    TP* p = static_cast<TP*>(ent.p) + start;
    const TG* g = static_cast<const TG*>(ent.g) + start;
    TM* mu = static_cast<TM*>(ent.mu) + start;
    TM* nu = static_cast<TM*>(ent.nu) + start;
    const float lr = ent.lr;
    if (n >= kBlock && aligned16(p) && aligned16(g) && aligned16(mu) &&
        aligned16(nu)) {
      // kGroup vectors of each array in flight per thread: all four with
      // bf16 state, two at a time where fp32 doubles the registers
#pragma unroll
      for (int it0 = 0; it0 < kItems; it0 += kGroup) {
        Raw<TP> pr[kGroup];
        Raw<TG> gr[kGroup];
        Raw<TM> mr[kGroup], vr[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int i0 = ((it0 + k) * kThreads + threadIdx.x) * kVec;
          load_raw(g + i0, gr[k]);
          load_raw(p + i0, pr[k]);
          load_raw(mu + i0, mr[k]);
          load_raw(nu + i0, vr[k]);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
          unpack(pr[k], pv);
          unpack(gr[k], gv);
          unpack(mr[k], mv);
          unpack(vr[k], vv);
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            adam1(pv[j], gv[j], mv[j], vv[j], lr, s, clip, norm);
          const int i0 = ((it0 + k) * kThreads + threadIdx.x) * kVec;
          store8(p + i0, pv);
          store8(mu + i0, mv);
          store8(nu + i0, vv);
        }
      }
    } else {
      // a tail block or an unaligned tensor: element by element
      const int lim = n < kBlock ? (int)n : kBlock;
      for (int i = threadIdx.x; i < lim; i += kThreads) {
        float pf = to_f(p[i]), mf = to_f(mu[i]), vf = to_f(nu[i]);
        adam1(pf, to_f(g[i]), mf, vf, lr, s, clip, norm);
        p[i] = from_f<TP>(pf);
        mu[i] = from_f<TM>(mf);
        nu[i] = from_f<TM>(vf);
      }
    }
  }
}

template <typename TG>
__device__ __forceinline__ float block_sumsq(const TG* g, long long n) {
  float acc = 0.f;
  if (n >= kBlock && aligned16(g)) {
    Raw<TG> r[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it)
      load_raw(g + (it * kThreads + threadIdx.x) * kVec, r[it]);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      float x[kVec];
      unpack(r[it], x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], x[j]));
    }
  } else {
    const int lim = n < kBlock ? (int)n : kBlock;
    for (int i = threadIdx.x; i < lim; i += kThreads) {
      const float x = to_f(g[i]);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
  }
  return acc;
}

// partials[b] = the sum of squares of work block b's gradient elements, for
// every block of the table; a fixed tree per block.
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const Entry* __restrict__ table, int n_entries,
                   long long n_blocks, float* __restrict__ partials) {
  __shared__ float warp_sums[kThreads / 32];
  int e = 0;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    e = seek(table, e, n_entries, b);
    const Entry ent = table[e];
    const long long start = (b - ent.blk) * kBlock;
    const long long n = ent.numel - start;
    float acc = ent.g_bf16
        ? block_sumsq(static_cast<const bf16*>(ent.g) + start, n)
        : block_sumsq(static_cast<const float*>(ent.g) + start, n);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, warp_sums[w]);
      partials[b] = t;
    }
    __syncthreads();
  }
}

// sums[grp] = the fp64 sum, rounded to fp32, of the partials of the blocks
// of every entry in norm group grp (one CTA per group): each thread takes
// the blocks j = tid, tid + 1024, ... of each entry in table order, then a
// fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
adamw_reduce_kernel(const Entry* __restrict__ table, int n_entries,
                    const float* __restrict__ partials,
                    float* __restrict__ sums) {
  __shared__ double part[kReduceThreads];
  const int grp = blockIdx.x;
  double acc = 0.0;
  for (int e = 0; e < n_entries; ++e) {
    if (__ldg(&table[e].group) != grp) continue;
    const long long blk = __ldg(&table[e].blk);
    const long long nb = (__ldg(&table[e].numel) + kBlock - 1) / kBlock;
    for (long long j = threadIdx.x; j < nb; j += kReduceThreads)
      acc += (double)partials[blk + j];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[grp] = (float)part[0];
}

// A persistent grid for `kernel`: at most the CTAs the card holds at once,
// and no more than there are work blocks.
template <typename K>
cudaError_t grid_for(K kernel, long long n_blocks, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(n_blocks < wave ? n_blocks : wave);
  return cudaSuccess;
}

template <typename TP, typename TG, typename TM>
int launch_update(const Entry* table, int lo, int hi, long long blk_lo,
                  long long blk_hi, const Scalars& s, const float* norm,
                  cudaStream_t st) {
  auto kernel = adamw_update_kernel<TP, TG, TM>;
  int grid = 0;
  cudaError_t err = grid_for(kernel, blk_hi - blk_lo, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, 0, st>>>(table, lo, hi, blk_lo, blk_hi, s, norm);
  return (int)cudaGetLastError();
}

}  // namespace

// The norm pass over the device table [n_entries] (entries sorted by blk,
// none empty, n_blocks = the last entry's blk + its blocks): partials gets
// one fp32 sum of squares per work block (n_blocks floats).
extern "C" int mm_adamw_sumsq(const void* table, int n_entries,
                              long long n_blocks, float* partials,
                              void* stream) {
  if (table == nullptr || partials == nullptr || n_entries <= 0 ||
      n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t err = grid_for(adamw_sumsq_kernel, n_blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  adamw_sumsq_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const Entry*>(table), n_entries, n_blocks, partials);
  return (int)cudaGetLastError();
}

// sums[n_groups]: each norm group's sum of the partials of its entries'
// blocks, in table order.
extern "C" int mm_adamw_reduce(const void* table, int n_entries,
                               int n_groups, const float* partials,
                               float* sums, void* stream) {
  if (table == nullptr || partials == nullptr || sums == nullptr ||
      n_entries <= 0 || n_groups <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  adamw_reduce_kernel<<<n_groups, kReduceThreads, 0, st>>>(
      static_cast<const Entry*>(table), n_entries, partials, sums);
  return (int)cudaGetLastError();
}

// The update pass over entries [lo, hi) of the device table, whose work
// blocks are [blk_lo, blk_hi). dtypes: bit 0 p, bit 1 g, bit 2 mu and nu,
// each 1 for bf16 and 0 for fp32. scalars: host memory. norm: the device
// fp32 global norm, read where scalars->clip.
extern "C" int mm_adamw_update(const void* table, int lo, int hi,
                               long long blk_lo, long long blk_hi,
                               int dtypes, const void* scalars,
                               const float* norm, void* stream) {
  if (table == nullptr || scalars == nullptr || lo < 0 || hi <= lo ||
      blk_hi <= blk_lo || dtypes < 0 || dtypes > 7)
    return (int)cudaErrorInvalidValue;
  const Scalars s = *static_cast<const Scalars*>(scalars);
  if (s.clip && norm == nullptr) return (int)cudaErrorInvalidValue;
  const Entry* t = static_cast<const Entry*>(table);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtypes) {
#define MM_ADAMW_CASE(code, TP, TG, TM)                                      \
  case code:                                                                 \
    return launch_update<TP, TG, TM>(t, lo, hi, blk_lo, blk_hi, s, norm, st);
    MM_ADAMW_CASE(0, float, float, float)
    MM_ADAMW_CASE(1, bf16, float, float)
    MM_ADAMW_CASE(2, float, bf16, float)
    MM_ADAMW_CASE(3, bf16, bf16, float)
    MM_ADAMW_CASE(4, float, float, bf16)
    MM_ADAMW_CASE(5, bf16, float, bf16)
    MM_ADAMW_CASE(6, float, bf16, bf16)
    MM_ADAMW_CASE(7, bf16, bf16, bf16)
#undef MM_ADAMW_CASE
  }
  return (int)cudaErrorInvalidValue;
}
