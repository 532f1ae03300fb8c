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
//   drafts, an earlier fill), and they are never loaded.
//
// Two kernels, chosen by the problem's packed query rows G*C (G = H / KV
// query heads per kv head; row i is chunk token i / G, head kvh*G + i % G,
// so every K/V tile serves all G heads and K/V are never repeated):
//   - G*C > 16, the fill form (C = 256, G*C = 1024 rows per key): the
//     tensor cores bound it. `chunk_fill.cu`: wgmma, TMA, a 2-stage ring
//     under mbarriers, a producer warp, key splits merged in the launch;
//   - G*C <= 16, the verify form (C = spec_k = 4, G = 4: 16 rows per key,
//     about 16 FLOP per byte of K/V, far under the card's ~295): HBM bytes
//     bound it. This file's kernel.
//
// What the verify form's design does about it (kernel B's, moved to 16
// packed rows):
//   * the grid is (key split, kv head, chunk). Split s of a chunk covers
//     the keys [s * split_len, (s + 1) * split_len) of its row, cut at the
//     chunk's last visible key off + C - 1; the host picks the split count
//     from S, NB, KV and the SM count only (`verify_splits`; the offsets
//     live on the device), and split_len is the least multiple of 64 with
//     n_split * split_len >= S. So the longest row spreads over the card;
//     a split that starts past the chunk's last visible key writes an
//     empty partial (m = -1e30, l = 0) and loads nothing;
//   * 64-key K and V tiles stream into shared memory through a 3-stage
//     ring of 16-byte `cp.async` copies (consecutive threads on consecutive
//     16 bytes of a key row), two tiles in flight while one is used; keys
//     past the split arrive as zeros and are masked;
//   * each of the four warps takes 16 keys of a tile and runs
//     `mma.sync.m16n8k16` on the G*C <= 16 packed rows: S = Q K^T with Q's
//     A fragments held in registers for the whole loop and K's B fragments
//     from `ldmatrix`, an online softmax per warp, and O += P V with P taken
//     from the S accumulators as the A operand and V's B fragments from
//     `ldmatrix.trans` (padded rows: conflict-free);
//   * the warps' states merge through shared memory into the CTA's fp32
//     partial (unnormalised O, m, l per row, log2 domain) in a workspace;
//     the last CTA of a (chunk, kv head) to arrive (an arrival counter:
//     __threadfence + atomicAdd) merges the partials in split order and
//     resets the counter, so repeats are bitwise equal and no second kernel
//     is launched. The wrapper owns the workspace and the zeroed counters.
// int8: the ring holds the int8 tiles and their scales as they land; all
// threads convert each landed tile into one bf16 tile (exact for
// |v| <= 127, by `sm90::i8x4_to_f32`, no I2F), which the warps then read
// as in bf16. k_scale multiplies the fp32 score, v_scale multiplies P
// before its bf16 rounding, and the softmax sum takes the unscaled P.

#include "sm90.cuh"

namespace {

using sm90::bf16;
using sm90::pack_bf16;

constexpr int TK = 64;             // keys per tile: 16 per warp
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int NT = 128;            // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int ROWS = 16;           // packed query rows: one m16 tile
constexpr int SPLIT_QUANTUM = 64;  // split_len is a multiple of this
// the merge keeps (n_split + 1) * ROWS weights where the warps' O was
// (NWARP * ROWS * D >= 4096 floats)
constexpr int MAX_SPLITS = 255;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.44269504088896340736f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] holds its (row lane / 4, columns 2 (lane % 4) + 0..1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

// the same, transposed: r[i] holds matrix i's (rows 2 (lane % 4) + 0..1,
// column lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, typename T>
struct VerifySmem {
  static constexpr bool Q8 = sizeof(T) == 1;
  static constexpr int LDS = D + 8;             // padded bf16 row (elements)
  static constexpr int TILE = TK * LDS * 2;     // one bf16 K (or V) tile
  static constexpr int LAND = TK * D;           // one int8 tile as it lands
  // bf16: the ring of (K, V) tiles; int8: the ring of landing tiles plus
  // the one converted bf16 (K, V) tile
  static constexpr int RING =
      Q8 ? STAGES * 2 * LAND + 2 * TILE : STAGES * 2 * TILE;
  static constexpr int RED = NWARP * ROWS * D * 4;   // warps' O at the end
  static constexpr int BIG = RING > RED ? RING : RED;
  static constexpr int SCL = Q8 ? STAGES * 2 * TK * 4 : 0;   // k/v scales
  // ring (or the warps' O), scales, the warps' m and l, the flag
  static constexpr int BYTES = BIG + SCL + 2 * NWARP * ROWS * 4 + 16;
};

// T is the cache element: bf16, or int8_t with the scale planes ks / vs
// (null for bf16), addressed like the cache without the head dim.
// ws: [P][ROWS][D] partial O, then [P][ROWS][2] (m, l); P = NB * KV *
// splits.
template <int D, typename T>
__global__ void __launch_bounds__(NT)
verify_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, bf16* __restrict__ o,
                   const int* __restrict__ rows, const int* __restrict__ offs,
                   int C, int H, int S, int split_len, int64_t layer_off,
                   int64_t c_sb, int64_t c_sh, int64_t sc_layer_off,
                   int64_t sc_sb, int64_t sc_sh, float scale_log2,
                   float* __restrict__ ws, int* __restrict__ counters) {
  using SM = VerifySmem<D, T>;
  constexpr bool Q8 = SM::Q8;
  constexpr int LDS = SM::LDS;
  constexpr int KC = D / 16;            // 16-deep steps of the head dim
  constexpr int NTO = D / 8;            // 8-wide n tiles of the head dim
  constexpr int EPV = 16 / sizeof(T);   // cache values per 16-byte copy
  constexpr int VPR = D / EPV;          // 16-byte copies per cache row
  constexpr int SROW = Q8 ? D : LDS * 2;   // bytes between rows of a stage
  constexpr int STG = Q8 ? SM::LAND : SM::TILE;   // one K (or V) stage
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem);   // after the loop
  float* scl = reinterpret_cast<float*>(smem + SM::BIG);  // [stage][k|v][TK]
  float* red_m = scl + SM::SCL / 4;               // [NWARP][ROWS]
  float* red_l = red_m + NWARP * ROWS;
  int* flag = reinterpret_cast<int*>(red_l + NWARP * ROWS);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int nb = blockIdx.z;
  const int nsplit = gridDim.x;
  const int KV = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int G = H / KV;
  const int GC = G * C;

  const int row = rows[nb];
  const int off = offs[nb];
  // the chunk's last token sees keys up to off + C - 1; nothing past it
  // (stale entries) is ever loaded
  const int kv_end = max(0, min(S, off + C));
  const int lo = split * split_len;
  const int hi = min(kv_end, lo + split_len);
  const int n_tiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;

  const T* kb = kc + layer_off + row * c_sb + kvh * c_sh;
  const T* vb = vc + layer_off + row * c_sb + kvh * c_sh;
  const int64_t sc_off = sc_layer_off + row * sc_sb + kvh * sc_sh;
  const int64_t n_part = (int64_t)nsplit * KV * gridDim.z;
  const int64_t pidx = ((int64_t)nb * KV + kvh) * nsplit + split;
  float* ws_ml = ws + n_part * ROWS * D;

  if (n_tiles > 0) {
    auto load_tile = [&](int t) {
      unsigned char* kd = ring + (t % STAGES) * 2 * STG;
      unsigned char* vd = kd + STG;
      const int k0 = lo + t * TK;
      for (int i = tid; i < TK * VPR; i += NT) {
        const int r = i / VPR;
        const int u = i % VPR;      // 16-byte unit of the row
        const bool ok = k0 + r < hi;
        const int64_t src = (int64_t)(ok ? k0 + r : lo) * D + u * EPV;
        sm90::cp_async16(kd + r * SROW + u * 16, kb + src, ok);
        sm90::cp_async16(vd + r * SROW + u * 16, vb + src, ok);
      }
      if constexpr (Q8) {
        if (tid < 2 * TK) {
          const int r = tid % TK;
          const bool ok = k0 + r < hi;
          const float* plane = tid < TK ? ks : vs;
          sm90::cp_async4(scl + ((t % STAGES) * 2 + tid / TK) * TK + r,
                          plane + sc_off + (ok ? k0 + r : lo), ok);
        }
      }
    };
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      sm90::cp_commit();
    }

    // packed rows g and g + 8 -> (chunk token r / G, head kvh * G + r % G);
    // rows past G*C read row 0 (their outputs are never written)
    const int r0 = g;
    const int r1 = g + 8;
    const int lim0 = off + r0 / G;   // the last key each row may see
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
      qf[kc][0] = ld32(q0p + c);
      qf[kc][1] = ld32(q1p + c);
      qf[kc][2] = ld32(q0p + c + 8);
      qf[kc][3] = ld32(q1p + c + 8);
    }

    float oacc[NTO][4];
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
      oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};         // partial row sums over own columns
    const int kw = warp * 16;        // this warp's 16 keys of each tile
    // ldmatrix row addresses: S's B fragments (keys kw + 0..15, two 8-dim
    // halves of a 16-deep step) and PV's (keys as the depth, 16 head dims)
    const int k_key = kw + (lane & 7) + (lane >> 4) * 8;
    const int k_dim = ((lane >> 3) & 1) * 8;
    const int v_key = kw + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_dim = (lane >> 4) * 8;

    for (int t = 0; t < n_tiles; ++t) {
      sm90::cp_wait<STAGES - 2>();
      __syncthreads();               // tile t landed; tile t - 1 is consumed
      if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
      sm90::cp_commit();
      const int st = t % STAGES;
      const int k0 = lo + t * TK;
      const bf16* kt;
      const bf16* vt;
      const float* ksc = scl + st * 2 * TK;   // int8 only
      const float* vsc = ksc + TK;
      if constexpr (Q8) {
        // the landed int8 tiles -> the bf16 tile, 16 values a step
        const unsigned char* land = ring + st * 2 * STG;
        bf16* conv = reinterpret_cast<bf16*>(ring + STAGES * 2 * STG);
#pragma unroll 4
        for (int i = tid; i < 2 * TK * (D / 16); i += NT) {
          const int w = i / (TK * (D / 16));   // 0: K, 1: V
          const int r = (i / (D / 16)) % TK;
          const int c = (i % (D / 16)) * 16;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              land + w * STG + r * D + c);
          float f[16];
          sm90::i8x4_to_f32(raw.x, f);
          sm90::i8x4_to_f32(raw.y, f + 4);
          sm90::i8x4_to_f32(raw.z, f + 8);
          sm90::i8x4_to_f32(raw.w, f + 12);
          uint32_t hv[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            hv[k] = sm90::pack_bf16_exact(f[2 * k], f[2 * k + 1]);
          bf16* dst = conv + w * TK * LDS + r * LDS + c;
          *reinterpret_cast<uint4*>(dst) = make_uint4(hv[0], hv[1], hv[2],
                                                      hv[3]);
          *reinterpret_cast<uint4*>(dst + 8) = make_uint4(hv[4], hv[5], hv[6],
                                                          hv[7]);
        }
        __syncthreads();
        kt = conv;
        vt = conv + TK * LDS;
      } else {
        kt = reinterpret_cast<const bf16*>(ring + st * 2 * STG);
        vt = kt + TK * LDS;
      }

      // S = Q K^T: the 16 rows x this warp's 16 keys (two n8 tiles)
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + k_key * LDS + kc * 16 + k_dim);
        mma_16816(s[0], qf[kc], bk[0], bk[1]);
        mma_16816(s[1], qf[kc], bk[2], bk[3]);
      }

      // scale (fp32, log2 domain; k_scale for int8), mask, row max
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kw + nt * 8 + tig * 2 + (e & 1);
          const int col = k0 + j;
          const bool ok = col < hi && col <= ((e < 2) ? lim0 : lim1);
          const float sc = Q8 ? scale_log2 * ksc[j] : scale_log2;
          s[nt][e] = ok ? s[nt][e] * sc : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (s[nt][e] == NEG_INF) ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[nt][e] = Q8 ? p * vsc[kw + nt * 8 + tig * 2 + (e & 1)] : p;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt) {
        oacc[nt][0] *= alpha[0];
        oacc[nt][1] *= alpha[0];
        oacc[nt][2] *= alpha[1];
        oacc[nt][3] *= alpha[1];
      }

      // O += P V: the warp's 16 keys are the depth; P's accumulator layout
      // is the A-operand layout
      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int nt = 0; nt < NTO; nt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + v_key * LDS + nt * 8 + v_dim);
        mma_16816(oacc[nt], pa, bv[0], bv[1]);
        mma_16816(oacc[nt + 1], pa, bv[2], bv[3]);
      }
    }

    // the warps' states -> the CTA's partial (unnormalised O, m, l)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    sm90::cp_wait<0>();
    __syncthreads();                 // the ring is dead; reuse it
    float* ob_w = red + warp * ROWS * D;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      const int c = nt * 8 + tig * 2;
      *reinterpret_cast<float2*>(ob_w + g * D + c) =
          make_float2(oacc[nt][0], oacc[nt][1]);
      *reinterpret_cast<float2*>(ob_w + (g + 8) * D + c) =
          make_float2(oacc[nt][2], oacc[nt][3]);
    }
    if (tig == 0) {
      red_m[warp * ROWS + g] = m[0];
      red_l[warp * ROWS + g] = l[0];
      red_m[warp * ROWS + g + 8] = m[1];
      red_l[warp * ROWS + g + 8] = l[1];
    }
    __syncthreads();
    float* ws_o = ws + pidx * ROWS * D;
    for (int i = tid; i < ROWS * D; i += NT) {
      const int rr = i / D;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) M = fmaxf(M, red_m[w * ROWS + rr]);
      float O = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w)
        O += red[w * ROWS * D + i] * exp2f(red_m[w * ROWS + rr] - M);
      ws_o[i] = O;
    }
    if (tid < ROWS) {
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) M = fmaxf(M, red_m[w * ROWS + tid]);
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w)
        L += red_l[w * ROWS + tid] * exp2f(red_m[w * ROWS + tid] - M);
      ws_ml[pidx * ROWS * 2 + tid * 2] = L > 0.f ? M : NEG_INF;
      ws_ml[pidx * ROWS * 2 + tid * 2 + 1] = L;
    }
  } else if (tid < ROWS) {
    // no key of this split is visible to the chunk: an empty partial
    ws_ml[pidx * ROWS * 2 + tid * 2] = NEG_INF;
    ws_ml[pidx * ROWS * 2 + tid * 2 + 1] = 0.f;
  }

  // arrival: the last CTA of this (chunk, kv head) merges every partial
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + nb * KV + kvh;
    const int last = atomicAdd(ctr, 1) == nsplit - 1;
    if (last) *ctr = 0;              // every split has arrived: ready to reuse
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int64_t p0 = ((int64_t)nb * KV + kvh) * nsplit;
  // per row: each split's weight exp2(m_s - M) (0 for an empty split),
  // then 1 / L; [nsplit + 1][ROWS] floats where the warps' O was
  float* wts = red;
  if (tid < ROWS) {
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) {
      const float* ml = ws_ml + ((p0 + s) * ROWS + tid) * 2;
      if (__ldcg(ml + 1) > 0.f) M = fmaxf(M, __ldcg(ml));
    }
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ml = ws_ml + ((p0 + s) * ROWS + tid) * 2;
      const float ls = __ldcg(ml + 1);
      const float w = ls > 0.f ? exp2f(__ldcg(ml) - M) : 0.f;
      wts[s * ROWS + tid] = w;
      L += ls * w;
    }
    wts[nsplit * ROWS + tid] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < GC * (D / 4); i += NT) {
    const int rr = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float w = wts[s * ROWS + rr];
      if (w > 0.f) {                 // an empty partial holds no O
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            ws + ((p0 + s) * ROWS + rr) * D + d));
        O.x += x.x * w;
        O.y += x.y * w;
        O.z += x.z * w;
        O.w += x.w * w;
      }
    }
    const float inv = wts[nsplit * ROWS + rr];
    bf16* dst = o + (((int64_t)nb * C + rr / G) * H + kvh * G + rr % G) * D;
    *reinterpret_cast<uint2*>(dst + d) =
        make_uint2(pack_bf16(O.x * inv, O.y * inv),
                   pack_bf16(O.z * inv, O.w * inv));
  }
}

template <int D, typename T>
int launch_verify(int NB, int C, int H, int KV, cudaStream_t st,
                  const bf16* q, const T* kc, const T* vc, const float* ks,
                  const float* vs, bf16* o, const int* rows, const int* offs,
                  int S, int64_t layer_off, int64_t c_sb, int64_t c_sh,
                  int64_t sc_layer_off, int64_t sc_sb, int64_t sc_sh,
                  float scale_log2, int n_split, float* ws, int* counters) {
  constexpr int bytes = VerifySmem<D, T>::BYTES;
  const cudaError_t e = sm90::smem_opt_in<verify_attn_kernel<D, T>>(bytes);
  if (e != cudaSuccess) return (int)e;
  // the least multiple of SPLIT_QUANTUM with n_split * split_len >= S
  const int split_len = ((S + n_split - 1) / n_split + SPLIT_QUANTUM - 1) /
                        SPLIT_QUANTUM * SPLIT_QUANTUM;
  const dim3 grid(n_split, KV, NB);
  verify_attn_kernel<D, T><<<grid, NT, bytes, st>>>(
      q, kc, vc, ks, vs, o, rows, offs, C, H, S, split_len, layer_off, c_sb,
      c_sh, sc_layer_off, sc_sb, sc_sh, scale_log2, ws, counters);
  return (int)cudaGetLastError();
}

template <typename T>
int verify(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* rows, const int* offs,
           int NB, int C, int H, int KV, int S, int D, int64_t layer_off,
           int64_t c_sb, int64_t c_sh, int64_t sc_layer_off, int64_t sc_sb,
           int64_t sc_sh, float scale_log2, int n_split, float* ws,
           int* counters, void* stream) {
  if (n_split <= 0 || n_split > MAX_SPLITS || NB > 65535 || KV > 65535 ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_verify<128, T>(NB, C, H, KV, st, qp, kp, vp, ks, vs, op,
                                 rows, offs, S, layer_off, c_sb, c_sh,
                                 sc_layer_off, sc_sb, sc_sh, scale_log2,
                                 n_split, ws, counters);
  if (D == 64)
    return launch_verify<64, T>(NB, C, H, KV, st, qp, kp, vp, ks, vs, op,
                                rows, offs, S, layer_off, c_sb, c_sh,
                                sc_layer_off, sc_sb, sc_sh, scale_log2,
                                n_split, ws, counters);
  return (int)cudaErrorInvalidValue;
}

bool bad_args(int NB, int C, int H, int KV, int S) {
  return NB <= 0 || C <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0;
}

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
// offs [NB] int32 on the device. Both forms split each problem's keys into
// n_split parts merged through ws / counters: the verify form always (ws:
// NB * KV * n_split * 16 * (D + 2) floats, counters: NB * KV ints), the
// fill form when n_split > 1 (see chunk_fill.cu). Counters are zero before
// the first launch, and each launch leaves them zero. Returns a
// cudaError_t as int (0 = launched).
extern "C" int mm_chunk_attn_bf16(
    const void* q, const void* k, const void* v, void* o, const int* rows,
    const int* offs, int NB, int C, int H, int KV, int S, int D, int Bc,
    int64_t layer_off, int64_t c_sb, int64_t c_sh, float scale, int n_split,
    float* ws, int* counters, void* stream) {
  if (bad_args(NB, C, H, KV, S)) return (int)cudaErrorInvalidValue;
  if ((H / KV) * C > ROWS)
    return mm_chunk_fill_bf16(q, k, v, o, rows, offs, NB, C, H, KV, S, D, Bc,
                              layer_off, c_sb, c_sh, scale * LOG2E, n_split,
                              ws, counters, stream);
  return verify<bf16>(q, k, v, nullptr, nullptr, o, rows, offs, NB, C, H, KV,
                      S, D, layer_off, c_sb, c_sh, 0, 0, 0, scale * LOG2E,
                      n_split, ws, counters, stream);
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
  if ((H / KV) * C > ROWS)
    return mm_chunk_fill_int8(q, k, v, k_scale, v_scale, o, rows, offs, NB, C,
                              H, KV, S, D, Bc, layer_off, c_sb, c_sh,
                              sc_layer_off, sc_sb, sc_sh, scale * LOG2E,
                              n_split, ws, counters, stream);
  return verify<int8_t>(q, k, v, k_scale, v_scale, o, rows, offs, NB, C, H,
                        KV, S, D, layer_off, c_sb, c_sh, sc_layer_off, sc_sb,
                        sc_sh, scale * LOG2E, n_split, ws, counters, stream);
}
