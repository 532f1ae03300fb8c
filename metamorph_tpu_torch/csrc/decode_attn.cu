// Decode attention for Hopper (sm_90a), kernel B: one new query token per
// batch row against its window [start, length) of the stacked KV cache
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
// the limit, so the card's bandwidth must be spread over every SM, each
// K/V row must be read once, and enough bytes must be in flight.
//
// What the design does about it (flash-decoding, one launch):
//   * the grid is (key split, kv head, batch row). Split s of a row covers
//     the keys [s * split_len, (s + 1) * split_len) of its window; the host
//     sizes split_len from S and the SM count alone (the wrapper never
//     reads `lengths`): about four CTAs per SM, so that the longest row is
//     cut into short runs and even a batch of one spreads over the card;
//     a CTA whose range misses [start, length) writes an empty partial;
//   * a CTA serves all G = H/KV query heads of its kv head from one read of
//     its keys (the TPU kernel's "all heads in one program" idea);
//   * 32-key K and V tiles stream into shared memory through a 3-stage
//     ring of 16-byte `cp.async` copies (coalesced: consecutive threads
//     read consecutive 16 bytes of a contiguous [keys, Dh] block), so two
//     tiles are in flight while one is used; keys past the range arrive as
//     zeros;
//   * scores: 4-16 lanes share a key row (16 bytes each, with the matching
//     q values of all G heads held in registers) and reduce with shuffles;
//     softmax: one lane per key, one warp per head; PV: a thread owns 8
//     head dims of every head for a subset of the tile's keys;
//   * each CTA writes its fp32 partial (m, l, unnormalised o[G, Dh]) to a
//     workspace; the last CTA of a (row, kv head) to arrive (an arrival
//     counter: __threadfence + atomicAdd) merges the partials in split
//     order and resets the counter, so repeats are bitwise equal and no
//     second kernel is launched. The wrapper owns the workspace and the
//     zeroed counters.
//
// int8: as in the Pallas kernel, the scales act on the [G, keys] planes,
// never on a dequantized slab: k_scale[j] multiplies key j's fp32 score,
// the softmax sum takes the unscaled probability, and p * v_scale[j] goes
// into the PV sum.
//
// Semantics held to the Pallas kernel: keys j with start <= j < length are
// visible; a row with an empty window outputs 0.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;               // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int TK = 32;                // keys per tile
constexpr int STAGES = 3;             // cp.async ring depth
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

template <int D, int G, typename T>
struct DecSmem {
  static constexpr int ROWB = D * (int)sizeof(T);   // bytes of a cache row
  static constexpr int TILEB = TK * ROWB;           // one K (or V) tile
  static constexpr int RING = STAGES * 2 * TILEB;
  static constexpr int NKS = NT / (D / 8);          // key subsets in PV
  static constexpr int RED = NKS * G * D * 4;       // PV partials at the end
  static constexpr int BIG = RING > RED ? RING : RED;
  // ring (or PV partials), q, scores, probabilities, alphas, the flag
  static constexpr int BYTES = BIG + (G * D + 2 * G * TK + G) * 4 + 16;
};

// T is the cache element: bf16, or int8_t with the scale planes ks / vs
// (null for bf16), addressed like the cache without the head dim.
// ws: [P][G][D] partial o, then [P][G][2] (m, l); P = B * KV * splits.
template <int D, int G, typename T>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, bf16* __restrict__ o,
                   const int* __restrict__ starts,
                   const int* __restrict__ lengths, int H, int S,
                   int split_len, int64_t layer_off, int64_t c_sb,
                   int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
                   int64_t sc_sh, float scale_log2, float* __restrict__ ws,
                   int* __restrict__ counters) {
  using SM = DecSmem<D, G, T>;
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int ROWB = SM::ROWB;
  constexpr int TILEB = SM::TILEB;
  constexpr int LPK = ROWB / 16;      // lanes per key row in the score step
  constexpr int EPV = 16 / sizeof(T); // cache values per 16-byte vector
  constexpr int KPW = 32 / LPK;       // keys per warp per score step
  constexpr int DG = D / 8;           // 8-wide head-dim groups in PV
  constexpr int NKS = SM::NKS;
  constexpr int HPW = (G + NWARP - 1) / NWARP;   // heads per softmax warp
  constexpr bool QREG = G * EPV <= 64;           // q slice in registers
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + SM::BIG);
  float* sbuf = qs + G * D;
  float* pbuf = sbuf + G * TK;
  float* alpha_s = pbuf + G * TK;
  int* flag = reinterpret_cast<int*>(alpha_s + G);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int KV = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int start = starts ? max(starts[b], 0) : 0;
  const int length = min(lengths[b], S);
  const int lo = max(start, split * split_len);
  const int hi = min(length, (split + 1) * split_len);
  const int n_tiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;

  const T* kb = kc + layer_off + b * c_sb + kvh * c_sh;
  const T* vb = vc + layer_off + b * c_sb + kvh * c_sh;
  const int64_t sc_off = sc_layer_off + b * sc_sb + kvh * sc_sh;
  const int64_t n_part = (int64_t)nsplit * KV * gridDim.z;
  const int64_t pidx = ((int64_t)b * KV + kvh) * nsplit + split;
  float* ws_ml = ws + n_part * G * D;

  if (n_tiles > 0) {
    // q for this group, pre-scaled into the log2 domain in fp32; a lane
    // of the score step always reads the same EPV head dims (c), so it
    // keeps their G * EPV q values in registers where they fit
    const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
    for (int i = tid; i < G * D; i += NT)
      qs[i] = __bfloat162float(qb[i]) * scale_log2;
    __syncthreads();
    const int c = lane % LPK;
    float qr[QREG ? G * EPV : 1];
    if constexpr (QREG) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < EPV; ++j) qr[g * EPV + j] = qs[g * D + c * EPV + j];
    }

    auto load_tile = [&](int t) {
      unsigned char* kd = ring + (t % STAGES) * 2 * TILEB;
      unsigned char* vd = kd + TILEB;
      const int k0 = lo + t * TK;
      for (int i = tid; i < TK * LPK; i += NT) {
        const int r = i / LPK;
        const int u = i % LPK;      // 16-byte unit of the row
        const bool ok = k0 + r < hi;
        const int64_t off = (int64_t)(ok ? k0 + r : lo) * D + u * EPV;
        sm90::cp_async16(kd + r * ROWB + u * 16, kb + off, ok);
        sm90::cp_async16(vd + r * ROWB + u * 16, vb + off, ok);
      }
    };
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      sm90::cp_commit();
    }

    float m_r[HPW], l_r[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      m_r[i] = NEG_INF;
      l_r[i] = 0.f;
    }
    float acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    const int dg = tid % DG;        // this thread's 8 head dims in PV
    const int ksub = tid / DG;      // and its keys: ksub, ksub + NKS, ...

    for (int t = 0; t < n_tiles; ++t) {
      sm90::cp_wait<STAGES - 2>();
      __syncthreads();              // tile t landed; tile t - 1 is consumed
      if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
      sm90::cp_commit();
      const unsigned char* kd = ring + (t % STAGES) * 2 * TILEB;
      const unsigned char* vd = kd + TILEB;
      const int k0 = lo + t * TK;

      // scores: warp w scores keys [8w, 8w + 8) of the tile, LPK lanes a key
#pragma unroll
      for (int kk0 = 0; kk0 < TK / NWARP; kk0 += KPW) {
        const int kk = warp * (TK / NWARP) + kk0 + lane / LPK;
        const uint4 raw = *reinterpret_cast<const uint4*>(kd + kk * ROWB +
                                                          c * 16);
        float kf[EPV];
        if constexpr (Q8) {
          sm90::i8x4_to_f32(raw.x, kf);
          sm90::i8x4_to_f32(raw.y, kf + 4);
          sm90::i8x4_to_f32(raw.z, kf + 8);
          sm90::i8x4_to_f32(raw.w, kf + 12);
        } else {
          const __nv_bfloat162* e =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(e[j]);
            kf[2 * j] = f.x;
            kf[2 * j + 1] = f.y;
          }
        }
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = 0.f;
#pragma unroll
          for (int j = 0; j < EPV; ++j)
            s[g] += (QREG ? qr[QREG ? g * EPV + j : 0]
                          : qs[g * D + c * EPV + j]) * kf[j];
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        if (c == 0) {
          const int key = k0 + kk;
          const bool valid = key < hi;
          const float ksc = (Q8 && valid) ? ks[sc_off + key] : 1.f;
#pragma unroll
          for (int g = 0; g < G; ++g)
            sbuf[g * TK + kk] = valid ? s[g] * ksc : NEG_INF;
        }
      }
      __syncthreads();

      // online softmax: warp w takes heads w, w + 4; lane = key
      {
        const int key = k0 + lane;
        const bool valid = key < hi;
        const float vsc = (Q8 && valid) ? vs[sc_off + key] : 1.f;
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const int g = warp + i * NWARP;
          if (g < G) {
            const float sv = sbuf[g * TK + lane];
            const float mnew = fmaxf(m_r[i], warp_max(sv));
            const float p = valid ? exp2f(sv - mnew) : 0.f;
            const float al = exp2f(m_r[i] - mnew);
            l_r[i] = l_r[i] * al + warp_sum(p);
            m_r[i] = mnew;
            pbuf[g * TK + lane] = p * vsc;   // v's dequant folded into p
            if (lane == 0) alpha_s[g] = al;
          }
        }
      }
      __syncthreads();

      // O += P V over this thread's keys and 8 head dims, every head
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float al = alpha_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= al;
      }
#pragma unroll
      for (int kk = ksub; kk < TK; kk += NKS) {
        float vf[8];
        if constexpr (Q8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(vd + kk * ROWB +
                                                            dg * 8);
          sm90::i8x4_to_f32(raw.x, vf);
          sm90::i8x4_to_f32(raw.y, vf + 4);
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(vd + kk * ROWB +
                                                            dg * 16);
          const __nv_bfloat162* e =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(e[j]);
            vf[2 * j] = f.x;
            vf[2 * j + 1] = f.y;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = pbuf[g * TK + kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += p * vf[e];
        }
      }
    }

    // this CTA's partial: PV sums over the key subsets, in a fixed order
    sm90::cp_wait<0>();
    __syncthreads();                // the ring is dead; reuse it
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(ksub * G + g) * D + dg * 8 + e] = acc[g][e];
    __syncthreads();
    float* ws_o = ws + pidx * G * D;
    for (int i = tid; i < G * D; i += NT) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NKS; ++k) sum += red[k * G * D + i];
      ws_o[i] = sum;
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int g = warp + i * NWARP;
        if (g < G) {
          ws_ml[pidx * G * 2 + g * 2] = m_r[i];
          ws_ml[pidx * G * 2 + g * 2 + 1] = l_r[i];
        }
      }
    }
  } else {
    // no key of this split is in the window: an empty partial
    for (int g = tid; g < G; g += NT) {
      ws_ml[pidx * G * 2 + g * 2] = NEG_INF;
      ws_ml[pidx * G * 2 + g * 2 + 1] = 0.f;
    }
  }

  // arrival: the last CTA of this (row, kv head) merges every partial
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + b * KV + kvh;
    const int last = atomicAdd(ctr, 1) == nsplit - 1;
    if (last) *ctr = 0;             // every split has arrived: ready to reuse
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int64_t p0 = ((int64_t)b * KV + kvh) * nsplit;
  bf16* ob = o + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) {
      const float* ml = ws_ml + (p0 + s) * G * 2 + g * 2;
      if (__ldcg(ml + 1) > 0.f) M = fmaxf(M, __ldcg(ml));
    }
    float L = 0.f, O = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ml = ws_ml + (p0 + s) * G * 2 + g * 2;
      const float l = __ldcg(ml + 1);
      if (l > 0.f) {               // empty partials hold no o
        const float f = exp2f(__ldcg(ml) - M);
        L += l * f;
        O += __ldcg(ws + (p0 + s) * G * D + i) * f;
      }
    }
    ob[i] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

template <int D, int G, typename T>
int launch_g(dim3 grid, cudaStream_t st, const bf16* q, const T* kc,
             const T* vc, const float* ks, const float* vs, bf16* o,
             const int* starts, const int* lengths, int H, int S,
             int split_len, int64_t layer_off, int64_t c_sb, int64_t c_sh,
             int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
             float scale_log2, float* ws, int* counters) {
  constexpr int bytes = DecSmem<D, G, T>::BYTES;
  const cudaError_t e =
      sm90::smem_opt_in<decode_attn_kernel<D, G, T>>(bytes);
  if (e != cudaSuccess) return (int)e;
  decode_attn_kernel<D, G, T><<<grid, NT, bytes, st>>>(
      q, kc, vc, ks, vs, o, starts, lengths, H, S, split_len, layer_off,
      c_sb, c_sh, sc_layer_off, sc_sb, sc_sh, scale_log2, ws, counters);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_d(int G, dim3 grid, cudaStream_t st, const bf16* q, const T* kc,
             const T* vc, const float* ks, const float* vs, bf16* o,
             const int* starts, const int* lengths, int H, int S,
             int split_len, int64_t layer_off, int64_t c_sb, int64_t c_sh,
             int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
             float scale_log2, float* ws, int* counters) {
#define MM_DECODE_CASE(GG)                                                   \
  case GG:                                                                  \
    return launch_g<D, GG, T>(grid, st, q, kc, vc, ks, vs, o, starts,       \
                              lengths, H, S, split_len, layer_off, c_sb,    \
                              c_sh, sc_layer_off, sc_sb, sc_sh, scale_log2, \
                              ws, counters);
  switch (G) {
    MM_DECODE_CASE(1)
    MM_DECODE_CASE(2)
    MM_DECODE_CASE(4)
    MM_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MM_DECODE_CASE
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* starts, const int* lengths,
           int B, int H, int KV, int S, int D, int64_t layer_off,
           int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
           int64_t sc_sh, float scale, int split_len, int n_split, float* ws,
           int* counters, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 ||
      split_len <= 0 || n_split <= 0 || (int64_t)split_len * n_split < S ||
      B > 65535 || KV > 65535 || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const dim3 grid(n_split, KV, B);
  const float scale_log2 = scale * 1.44269504088896340736f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_d<128, T>(G, grid, st, qp, kp, vp, ks, vs, op, starts,
                            lengths, H, S, split_len, layer_off, c_sb, c_sh,
                            sc_layer_off, sc_sb, sc_sh, scale_log2, ws,
                            counters);
  if (D == 64)
    return launch_d<64, T>(G, grid, st, qp, kp, vp, ks, vs, op, starts,
                           lengths, H, S, split_len, layer_off, c_sb, c_sh,
                           sc_layer_off, sc_sb, sc_sh, scale_log2, ws,
                           counters);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, D] contiguous; k/v caches with rows of D contiguous elements and
// the given b / kv-head strides (elements); `layer_off` is the element
// offset of the layer's [B, KV, S, D] block. `starts` may be null. The key
// range is cut into n_split splits of split_len keys (split_len * n_split
// >= S). ws: B * KV * n_split * G * (D + 2) floats of scratch; counters:
// B * KV ints, zero before the first launch (each launch leaves them zero).
// Returns a cudaError_t as int (0 = launched).
extern "C" int mm_decode_attn_bf16(
    const void* q, const void* k, const void* v, void* o, const int* starts,
    const int* lengths, int B, int H, int KV, int S, int D,
    int64_t layer_off, int64_t c_sb, int64_t c_sh, float scale,
    int split_len, int n_split, float* ws, int* counters, void* stream) {
  return launch<bf16>(q, k, v, nullptr, nullptr, o, starts, lengths, B, H, KV,
                      S, D, layer_off, c_sb, c_sh, 0, 0, 0, scale, split_len,
                      n_split, ws, counters, stream);
}

// The int8 cache: k/v int8 as above; k_scale/v_scale fp32 planes with one
// value per (token, kv head), `sc_layer_off` / `sc_sb` / `sc_sh` their layer
// offset and b / kv-head strides (elements; the token stride is 1).
extern "C" int mm_decode_attn_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* o, const int* starts, const int* lengths,
    int B, int H, int KV, int S, int D, int64_t layer_off, int64_t c_sb,
    int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
    float scale, int split_len, int n_split, float* ws, int* counters,
    void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, o, starts, lengths, B, H,
                        KV, S, D, layer_off, c_sb, c_sh, sc_layer_off, sc_sb,
                        sc_sh, scale, split_len, n_split, ws, counters,
                        stream);
}
