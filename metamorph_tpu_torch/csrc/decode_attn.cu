// Decode attention for Hopper (sm_90a): one new query token per batch row
// against its window [start, length) of the stacked KV cache
// [L, B, KV, S, Dh], bf16 or int8 with fp32 per-(token, kv head) scales
// [L, B, KV, S]. fp32 softmax and accumulation, bf16 out.
//
// Replaces: the Pallas TPU kernel `_decode_kernel` of
//   metamorph_tpu/ops/decode_attention.py (driven by `decode_attention`),
//   both branches: bf16 (`mm_decode_attn_bf16`) and the int8 cache
//   (`mm_decode_attn_int8`, one template instance of the same kernel).
//
// What bounds it on the H100: every cached key and value row is read once
// and used for G*Dh multiply-adds, about 1 FLOP per byte (2 per byte for
// int8) — far below the card's compute/bandwidth balance. HBM bytes are
// the limit, so the kernel must read each K/V row exactly once and keep
// enough loads in flight; the int8 cache halves those bytes.
//
// What the design does about it: one CTA per (batch row, kv head) serves
// all G = H/KV query heads of that group from a single read of the group's
// K/V (the TPU kernel's "all heads in one program" idea, per kv head here).
// The CTA receives the whole stacked cache plus the layer as a pointer
// offset, so no per-layer slice is ever copied. It loops only over the
// row's valid window, so cache beyond `length` costs no bytes. Eight warps
// take 32-key blocks round robin: in a block each lane scores one key
// against the G queries (its K row read as 16-byte vectors: 8 bf16 or 16
// int8 values), the warp reduces max and sum with shuffles, then the lanes
// split the head dim and stream the V rows coalesced. Each warp keeps its
// own online-softmax state; the eight partial states merge once through
// shared memory at the end. Splitting one row's window across CTAs
// (flash-decoding) for short batches is later work.
//
// int8: as in the Pallas kernel, the scales act on the [G, keys] planes,
// never on a dequantized [S, Dh] slab: a lane multiplies its key's score by
// k_scale[j], adds the unscaled probability to the softmax sum, and hands
// p * v_scale[j] to the PV loop.
//
// Semantics held to the Pallas kernel: keys j with start <= j < length are
// visible; a row with an empty window outputs 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 8;                 // warps per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T is the cache element: bf16, or int8_t with the scale planes ks / vs
// (null for bf16), addressed like the cache without the head dim.
template <int D, int G, typename T>
__global__ void __launch_bounds__(NW * 32)
decode_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, bf16* __restrict__ o,
                   const int* __restrict__ starts,
                   const int* __restrict__ lengths, int H, int S,
                   int64_t layer_off, int64_t c_sb, int64_t c_sh,
                   int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
                   float scale_log2) {
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int VEC = 16 / sizeof(T);  // cache values per 16-byte vector
  constexpr int DPL = D / 32;         // head-dim elements per lane in PV
  __shared__ float qs[G][D];
  __shared__ float red_m[NW][G];
  __shared__ float red_l[NW][G];
  __shared__ float red_o[NW][G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // q for this group, pre-scaled into the log2 domain in fp32
  const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NW * 32)
    qs[i / D][i % D] = __bfloat162float(qb[i]) * scale_log2;
  __syncthreads();

  const int start = starts ? max(starts[b], 0) : 0;
  const int length = min(lengths[b], S);
  const T* kb = kc + layer_off + b * c_sb + kvh * c_sh;
  const T* vb = vc + layer_off + b * c_sb + kvh * c_sh;
  const int64_t sc_off = sc_layer_off + b * sc_sb + kvh * sc_sh;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int k0 = start + warp * 32; k0 < length; k0 += NW * 32) {
    const int key = k0 + lane;
    const bool valid = key < length;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    float vsc = 0.f;                  // this lane's key: v_scale (int8)
    if (valid) {
      const T* kr = kb + (int64_t)key * D;
#pragma unroll 4
      for (int c = 0; c < D; c += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        if constexpr (Q8) {
          const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float kf = static_cast<float>(e[j]);
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] += qs[g][c + j] * kf;
          }
        } else {
          const __nv_bfloat162* e =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 kf = __bfloat1622float2(e[j]);
#pragma unroll
            for (int g = 0; g < G; ++g)
              s[g] += qs[g][c + 2 * j] * kf.x + qs[g][c + 2 * j + 1] * kf.y;
          }
        }
      }
      if constexpr (Q8) {
        const float ksc = ks[sc_off + key];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] *= ksc;
        vsc = vs[sc_off + key];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sv = valid ? s[g] : NEG_INF;
      const float mnew = fmaxf(m[g], warp_max(sv));
      const float p = valid ? exp2f(sv - mnew) : 0.f;
      const float alpha = exp2f(m[g] - mnew);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = mnew;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
      s[g] = Q8 ? p * vsc : p;        // v's dequant folded into p
    }
    const int nk = min(32, length - k0);
    const T* vr = vb + (int64_t)k0 * D + lane * DPL;
    for (int j = 0; j < nk; ++j) {
      float vf[DPL];
      if constexpr (Q8) {
        if constexpr (DPL == 4) {
          const char4 c4 = *reinterpret_cast<const char4*>(vr + (int64_t)j * D);
          vf[0] = c4.x; vf[1] = c4.y; vf[2] = c4.z; vf[3] = c4.w;
        } else {
          const char2 c2 = *reinterpret_cast<const char2*>(vr + (int64_t)j * D);
          vf[0] = c2.x; vf[1] = c2.y;
        }
      } else if constexpr (DPL == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(vr + (int64_t)j * D);
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(e[0]);
        const float2 c = __bfloat1622float2(e[1]);
        vf[0] = a.x; vf[1] = a.y; vf[2] = c.x; vf[3] = c.y;
      } else {
        const __nv_bfloat162 raw =
            *reinterpret_cast<const __nv_bfloat162*>(vr + (int64_t)j * D);
        const float2 a = __bfloat1622float2(raw);
        vf[0] = a.x; vf[1] = a.y;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, s[g], j);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] += pj * vf[d];
      }
    }
  }

  // merge the per-warp partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) red_o[warp][g][lane * DPL + d] = acc[g][d];
  }
  __syncthreads();
  bf16* ob = o + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D;
    const int d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, red_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(red_m[w][g] - M);
      L += red_l[w][g] * f;
      O += red_o[w][g][d] * f;
    }
    ob[i] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

template <int D, typename T>
int launch_d(int G, dim3 grid, cudaStream_t st, const bf16* q, const T* kc,
             const T* vc, const float* ks, const float* vs, bf16* o,
             const int* starts, const int* lengths, int H, int S,
             int64_t layer_off, int64_t c_sb, int64_t c_sh,
             int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
             float scale_log2) {
  const dim3 block(NW * 32);
#define MM_DECODE_CASE(GG)                                                   \
  case GG:                                                                  \
    decode_attn_kernel<D, GG, T><<<grid, block, 0, st>>>(                   \
        q, kc, vc, ks, vs, o, starts, lengths, H, S, layer_off, c_sb, c_sh, \
        sc_layer_off, sc_sb, sc_sh, scale_log2);                            \
    break;
  switch (G) {
    MM_DECODE_CASE(1)
    MM_DECODE_CASE(2)
    MM_DECODE_CASE(4)
    MM_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MM_DECODE_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* starts, const int* lengths,
           int B, int H, int KV, int S, int D, int64_t layer_off,
           int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
           int64_t sc_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const dim3 grid(KV, B);
  const float scale_log2 = scale * 1.44269504088896340736f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_d<128, T>(G, grid, st, qp, kp, vp, ks, vs, op, starts,
                            lengths, H, S, layer_off, c_sb, c_sh,
                            sc_layer_off, sc_sb, sc_sh, scale_log2);
  if (D == 64)
    return launch_d<64, T>(G, grid, st, qp, kp, vp, ks, vs, op, starts,
                           lengths, H, S, layer_off, c_sb, c_sh,
                           sc_layer_off, sc_sb, sc_sh, scale_log2);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, D] contiguous; k/v caches with rows of D contiguous elements and
// the given b / kv-head strides (elements); `layer_off` is the element
// offset of the layer's [B, KV, S, D] block. `starts` may be null.
// Returns a cudaError_t as int (0 = launched).
extern "C" int mm_decode_attn_bf16(
    const void* q, const void* k, const void* v, void* o, const int* starts,
    const int* lengths, int B, int H, int KV, int S, int D,
    int64_t layer_off, int64_t c_sb, int64_t c_sh, float scale,
    void* stream) {
  return launch<bf16>(q, k, v, nullptr, nullptr, o, starts, lengths, B, H, KV,
                      S, D, layer_off, c_sb, c_sh, 0, 0, 0, scale, stream);
}

// The int8 cache: k/v int8 as above; k_scale/v_scale fp32 planes with one
// value per (token, kv head), `sc_layer_off` / `sc_sb` / `sc_sh` their layer
// offset and b / kv-head strides (elements; the token stride is 1).
extern "C" int mm_decode_attn_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* o, const int* starts, const int* lengths,
    int B, int H, int KV, int S, int D, int64_t layer_off, int64_t c_sb,
    int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
    float scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, o, starts, lengths, B, H,
                        KV, S, D, layer_off, c_sb, c_sh, sc_layer_off, sc_sb,
                        sc_sh, scale, stream);
}
