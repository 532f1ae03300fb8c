// Weight-only int8 matrix product for Hopper (sm_90a), kernel F:
//   out[M, N] = bf16((x[M, K] . q[N, K]^T) * scale[N])
// x bf16, q int8 (one row of K per output channel, K contiguous), scale
// fp32, products summed in fp32, the output rounded to bf16 once.
//
// Replaces: no Pallas kernel. `quantized_matmul` of
//   metamorph_tpu/ops/quant.py leaves the int8 -> bf16 convert to XLA:TPU,
//   which fuses it into the dot, so the dequantized matrix never reaches
//   device memory. This kernel is that fusion on the card: the int8 weight
//   is read from device memory once and converted on chip.
//
// What bounds it on the H100: in decode (M <= 32 rows) every weight byte is
// used for at most 2 * 32 operations, far below the card's ~295 operations
// per byte: the int8 bytes are the limit. Large M (prefill buckets, the
// fill step's 8 + 256 rows) is bound by the bf16 tensor cores, which only
// wgmma reaches. The int8 -> bf16 convert is exact (|q| <= 127), so the
// kernel and its plain version differ only in the order of the fp32 sums.
//
// Two forms (helpers in sm90.cuh):
//   * "gemv" (M <= 64 rows, the decode, verify and draft steps): built for
//     bytes in flight. The weight is cut into units of 128 channels x 128
//     deep (16 KB); the units, tile by tile, k inner, are shared out in
//     equal contiguous runs over one wave of the grid (the host sizes it
//     from the kernel's residency, one CTA per SM, and prefers a grid whose
//     runs fit the tiles). A producer warp streams each unit by TMA
//     (128-byte swizzle) into a 4-stage ring, with the unit's 128-deep
//     slice of x beside it (cp.async, zero past M and K, completion counted
//     on the same mbarrier), so up to 64 KB of weight per SM is in flight
//     while four consumer warps convert the stage in shared memory and
//     multiply with `mma.sync.m16n8k16` (32 channels of weight per warp as
//     the A operand, x as B, 8 rows per n8 tile). The product's depth is
//     permuted inside each 64-deep block so that a lane's fragments come
//     from 16 contiguous weight bytes and 32 contiguous x bytes (A and B
//     take the same permutation, so the sum is unchanged), and lane g holds
//     channel row ((g & 1) << 2 | g >> 1) of its m16 tile, so that each
//     quarter warp's 16-byte reads hit distinct banks of the swizzled
//     stage. A CTA whose run covers a whole tile writes it directly; a tile
//     shared by several CTAs gets one fp32 partial from each, and the last
//     CTA to arrive (an arrival counter) sums them in CTA order, applies
//     the scale, writes bf16 and resets the counter: repeats are bitwise
//     equal and nothing else is launched;
//   * "tiled" (more rows; prefill buckets, the fill step): kernel A's
//     machinery with an int8 operand. Clusters of two CTAs, persistent, one
//     CTA per SM, walk pairs of adjacent 256-row x 128-channel output
//     tiles in groups of 8 row tiles (a weight tile is reused from L2 by
//     the group). Per 64-deep step a loader warp brings the int8 weight
//     tile by TMA into a 5-deep landing ring and this CTA's half of the
//     x tile by TMA multicast into both CTAs' 4-deep x ring (the x tile
//     crosses from L2 once for two weight tiles); three converter warps
//     turn the landed int8 into a bf16 stage in the 128-byte swizzled
//     layout wgmma reads; two consumer warpgroups of 64 channels each run
//     `wgmma.m64n256k16` with the weight as the A operand and the 256 x
//     rows as B, fp32 accumulators; the scale multiplies in the epilogue,
//     then one bf16 rounding. Rows past M, channels past N and depth past
//     K arrive as TMA zero fill and are not written. What bounds it: the
//     bytes each SM takes in per step (32 KB of x, 8 KB of int8) and the
//     tensor cores; the 256 x 128 tile is the one that keeps the
//     converters off the critical path.
#include <string.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// gemv form
constexpr int G_BN = 128;          // channels per tile (4 warps x 32)
constexpr int G_BK = 128;          // depth per unit, one ring stage
constexpr int G_STAGES = 4;
constexpr int G_CONSUMERS = 128;
constexpr int G_THREADS = G_CONSUMERS + 32;   // + the producer warp
constexpr int G_WB = G_BN * G_BK;  // one unit of int8 weight, 16 KB

// tiled form
constexpr int T_BM = 256, T_BN = 128, T_BK = 64;
constexpr int T_XS = 4;            // x stages (TMA, shared by the cluster)
constexpr int T_LS = 5;            // int8 landing stages (TMA)
constexpr int T_WS = 2;            // bf16 weight stages (converted)
constexpr int T_THREADS = 384;     // 2 consumer warpgroups + 1 producer
constexpr int T_CONVERTERS = 96;   // producer warps 1-3
constexpr int T_GROUP = 8;         // row tiles per group of the tile order

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four int8 (one word, lowest byte first) -> two bf16x2 words:
// lo = (v0, v1), hi = (v2, v3), exactly (through fp32: a byte permute and
// an add per value, see sm90.cuh)
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  lo = pack_bf16_exact(f[0], f[1]);
  hi = pack_bf16_exact(f[2], f[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------ gemv form
//
// Units u = tile * KB + k block, W of them; CTA c of P takes
// [c * W / P, (c + 1) * W / P), and the CTA holding unit u is
// ((u + 1) * P - 1) / W. A CTA's run is partial on at most its first and
// its last tile: partial slot 2c holds its first tile's, 2c + 1 its last's.

__device__ __forceinline__ int cta_of(int64_t u, int64_t W, int P) {
  return (int)(((u + 1) * P - 1) / W);
}

template <int NG>
struct GemvSmem {
  static constexpr int XB = 8 * NG * 128;     // x: 8NG rows x one 64-deep block
  static constexpr int STAGE = G_WB + 2 * XB;  // weight unit, x's two blocks
  static constexpr int BYTES = G_STAGES * STAGE + 2 * G_STAGES * 8 + 1024;
};

// Step (64 deep, block h of the stage): lane (g, t) holds the bytes
// 16t .. 16t + 15 of the block for channel rows r and r + 8 of each m16
// tile (one uint4 each) and the 16 activations at the same depth of row g
// of each n8 tile (two uint4). mma j of the step uses depth 16t + 4j +
// 0..3 in the fragment slots (2t, 2t + 1, 2t + 8, 2t + 9): A = {row r (4j,
// 4j+1), row r+8 (4j, 4j+1), row r (4j+2, 4j+3), row r+8 (4j+2, 4j+3)},
// B = {x (4j, 4j+1), x (4j+2, 4j+3)}. The accumulator of m16 tile i, n8
// tile n: c0, c1 = channel r, x rows 8n + 2t, 8n + 2t + 1; c2, c3 =
// channel r + 8, the same rows.
template <int NG>
__global__ void __launch_bounds__(G_THREADS)
w8_gemv_kernel(const __grid_constant__ CUtensorMap qmap,
               const bf16* __restrict__ x, const float* __restrict__ scale,
               bf16* __restrict__ out, int M, int N, int K,
               float* __restrict__ ws, int* __restrict__ counters) {
  using SM = GemvSmem<NG>;
  constexpr int PART = 8 * NG * G_BN;          // one partial, [rows][channels]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G_STAGES * SM::STAGE);
  uint64_t* empty = full + G_STAGES;
  __shared__ int last_flag;

  const int KB = (K + G_BK - 1) / G_BK;
  const int64_t W = (int64_t)((N + G_BN - 1) / G_BN) * KB;
  const int P = gridDim.x;
  const int64_t u_begin = (int64_t)blockIdx.x * W / P;
  const int64_t u_end = (int64_t)(blockIdx.x + 1) * W / P;

  if (threadIdx.x == G_CONSUMERS) prefetch_tmap(&qmap);
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 33);           // the TMA's arrival + 32 x copiers
      mbar_init(&empty[s], G_CONSUMERS / 32);   // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == G_CONSUMERS / 32) {
    // producer: the weight unit by TMA, x's slice by cp.async (16-byte
    // units of 8 activations, swizzled like the weight: unit ^ row % 8)
    int i = 0;
    for (int64_t u = u_begin; u < u_end; ++u, ++i) {
      const int s = i % G_STAGES;
      const int t = (int)(u / KB), b = (int)(u - (int64_t)t * KB);
      unsigned char* st = base + s * SM::STAGE;
      mbar_wait(&empty[s], ((i / G_STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], G_WB);
        tma_load_4d(st, &qmap, &full[s], b * G_BK, t * G_BN, 0, 0);
      }
      const int k0 = b * G_BK;
#pragma unroll
      for (int it = 0; it < 4 * NG; ++it) {
        const int idx = lane + 32 * it;        // 8NG rows x 16 units
        const int row = idx / 16, unit = idx % 16;
        const int k = k0 + unit * 8;
        const bool ok = row < M && k < K;
        cp_async16(st + G_WB + (unit / 8) * SM::XB + row * 128 +
                       (((unit % 8) ^ (row & 7)) << 4),
                   ok ? x + (size_t)row * K + k : x, ok);
      }
      cp_async_mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane / 4, t4 = lane % 4;
  const int pg = ((g & 1) << 2) | (g >> 1);   // the tile row lane g holds
  const int ch_lo = 32 * warp + pg;            // + 16 * m16 tile + 8 * half
  float acc[2][NG][4];
  int i = 0;
  for (int64_t u = u_begin; u < u_end;) {
    const int t = (int)(u / KB);
    const int b_lo = (int)(u - (int64_t)t * KB);
    const int64_t left = u_end - (int64_t)t * KB;
    const int b_hi = left < KB ? (int)left : KB;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][n][c] = 0.f;
    for (int b = b_lo; b < b_hi; ++b, ++i) {
      const int s = i % G_STAGES;
      mbar_wait(&full[s], (i / G_STAGES) & 1);
      const unsigned char* wst = base + s * SM::STAGE;
      const unsigned char* xst = wst + G_WB;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 wv[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            wv[mi][rr] = *reinterpret_cast<const uint4*>(
                wst + (ch_lo + 16 * mi + 8 * rr) * 128 +
                (((4 * h + t4) ^ pg) << 4));
        uint4 xv[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            xv[n][hh] = *reinterpret_cast<const uint4*>(
                xst + h * SM::XB + (8 * n + g) * 128 +
                (((2 * t4 + hh) ^ g) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            i8x4_to_bf16x4(word(wv[mi][0], j), a[mi][0], a[mi][2]);
            i8x4_to_bf16x4(word(wv[mi][1], j), a[mi][1], a[mi][3]);
          }
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const uint32_t b0 = word(xv[n][j / 2], 2 * (j % 2));
            const uint32_t b1 = word(xv[n][j / 2], 2 * (j % 2) + 1);
            mma_16816(acc[0][n], a[0], b0, b1);
            mma_16816(acc[1][n], a[1], b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    u = (int64_t)t * KB + b_hi;

    const int n0 = t * G_BN;
    const int first = cta_of((int64_t)t * KB, W, P);
    const int last = cta_of((int64_t)(t + 1) * KB - 1, W, P);
    if (first == last) {              // the whole tile is this CTA's
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = 8 * n + 2 * t4 + (c & 1);
            const int ch = n0 + ch_lo + 16 * mi + 8 * (c >> 1);
            if (m < M && ch < N)
              out[(size_t)m * N + ch] =
                  __float2bfloat16(acc[mi][n][c] * scale[ch]);
          }
      continue;
    }
    float* part = ws + ((size_t)blockIdx.x * 2 + (u_begin / KB == t ? 0 : 1))
                           * PART;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = 8 * n + 2 * t4 + (c & 1);
          if (m < M)
            part[m * G_BN + ch_lo + 16 * mi + 8 * (c >> 1)] = acc[mi][n][c];
        }
    // arrival (as a grid barrier does: the CTA's stores, a CTA barrier, one
    // fence and the atomic by one thread)
    named_bar_sync(1, G_CONSUMERS);
    if (threadIdx.x == 0) {
      __threadfence();
      const int done = atomicAdd(&counters[t], 1) == last - first;
      if (done) {
        counters[t] = 0;              // every CTA has arrived: reusable
        __threadfence();
      }
      last_flag = done;
    }
    named_bar_sync(1, G_CONSUMERS);
    if (!last_flag) continue;
    // the last to arrive sums the partials in CTA order (only the first
    // CTA's run can have begun before the tile: its partial is in slot 1,
    // the others' in 0). Thread (row group rg, quad cq) takes channels
    // 4cq .. 4cq + 3 of rows rg, rg + 4, ...; the loads of CU partials are
    // issued before their sums.
    constexpr int RW = 2 * NG;                 // rows per thread
    constexpr int CU = NG >= 8 ? 1 : 8 / NG;   // partials per batch
    const int cq = threadIdx.x % 32, rg = threadIdx.x / 32;
    const int first_slot =
        (int64_t)first * W < (int64_t)t * KB * P ? 1 : 0;
    float4 sum[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = first; c0 <= last; c0 += CU) {
      float4 v[CU][RW];
#pragma unroll
      for (int cu = 0; cu < CU; ++cu) {
        const int c = c0 + cu;
        const float* p = ws + ((size_t)c * 2 + (c == first ? first_slot : 0))
                                  * PART + 4 * cq;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int m = rg + 4 * i;
          v[cu][i] = c <= last && m < M
                         ? __ldcg(reinterpret_cast<const float4*>(
                               p + m * G_BN))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int cu = 0; cu < CU; ++cu)
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          sum[i].x += v[cu][i].x;
          sum[i].y += v[cu][i].y;
          sum[i].z += v[cu][i].z;
          sum[i].w += v[cu][i].w;
        }
    }
    const int ch = n0 + 4 * cq;
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = ch + e < N ? scale[ch + e] : 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int m = rg + 4 * i;
      if (m >= M) continue;
      bf16* o = out + (size_t)m * N + ch;
      if (ch + 3 < N && N % 4 == 0) {
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_bf16(sum[i].x * sc[0], sum[i].y * sc[1]),
                       pack_bf16(sum[i].z * sc[2], sum[i].w * sc[3]));
      } else {
        const float f[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ch + e < N) o[e] = __float2bfloat16(f[e] * sc[e]);
      }
    }
  }
}

// ------------------------------------------------------------ tiled form
//
// A cluster of two CTAs takes pairs of adjacent column tiles of one row
// tile: each CTA loads half of the x tile (128 rows) and multicasts it to
// both, so the x tile crosses from L2 once for two weight tiles. Within a
// CTA three rings run apart: x stages (filled by both CTAs' TMA), int8
// landing stages (filled by this CTA's TMA) and bf16 weight stages (filled
// by the converters). Producer warp 0 only issues loads, as soon as a
// stage is free; warps 1-3 convert; the consumer warpgroups multiply.

struct TiledSmem {
  static constexpr int X = T_BM * 128;      // x: 256 rows x 64 bf16, swizzled
  static constexpr int WB = T_BN * 128;     // weight: 128 channels x 64 bf16
  static constexpr int LAND = T_BN * T_BK;  // weight as it lands, int8
  static constexpr int BYTES = T_XS * X + T_WS * WB + T_LS * LAND +
                               16 * (T_XS + T_WS + T_LS) + 1024;
};

// pair i of MT row tiles x NP column-tile pairs, in groups of T_GROUP row
// tiles, pairs inner: the clusters in flight at once share a few weight
// column tiles from L2
__device__ __forceinline__ void pair_origin(int i, int MT, int NP, int& m0,
                                            int& np) {
  const int per_group = T_GROUP * NP;
  const int group = i / per_group;
  const int first = group * T_GROUP;
  const int size = min(MT - first, T_GROUP);
  const int r = i - group * per_group;
  m0 = (first + r % size) * T_BM;
  np = r / size;
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(T_THREADS, 1)
w8_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap qmap,
                const float* __restrict__ scale, bf16* __restrict__ out,
                int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* wst = xs + T_XS * TiledSmem::X;
  unsigned char* land = wst + T_WS * TiledSmem::WB;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(land + T_LS *
                                                 TiledSmem::LAND);
  uint64_t* x_empty = x_full + T_XS;
  uint64_t* l_full = x_empty + T_XS;
  uint64_t* l_empty = l_full + T_LS;
  uint64_t* w_full = l_empty + T_LS;
  uint64_t* w_empty = w_full + T_WS;

  const uint32_t rank = cluster_rank();
  const int MT = (M + T_BM - 1) / T_BM;
  const int NP = ((N + T_BN - 1) / T_BN + 1) / 2;
  const int pairs = MT * NP;
  const int KS = (K + T_BK - 1) / T_BK;
  const int cid = (int)blockIdx.x / 2, clusters = (int)gridDim.x / 2;
  const int mine = cid < pairs ? (pairs - 1 - cid) / clusters + 1 : 0;
  const int total = mine * KS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_XS; ++s) {
      mbar_init(&x_full[s], 1);            // this CTA's expect_tx
      mbar_init(&x_empty[s], 16);          // 8 consumer warps of each CTA
    }
    for (int l = 0; l < T_LS; ++l) {
      mbar_init(&l_full[l], 1);
      mbar_init(&l_empty[l], 1);           // the converters, together
    }
    for (int w = 0; w < T_WS; ++w) {
      mbar_init(&w_full[w], 1);
      mbar_init(&w_empty[w], 8);
    }
    fence_barrier_init();
  }
  if (threadIdx.x == 256) {
    prefetch_tmap(&xmap);
    prefetch_tmap(&qmap);
  }
  cluster_sync();                 // both CTAs' barriers are ready

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == 2) {
    reg_dealloc<72>();
    if (warp == 0) {
      // loads, each ring on its own lane so that neither waits behind the
      // other: lane 0 the int8 weight tiles, lane 1 this CTA's half of each
      // x tile, to both CTAs
      if (lane < 2) {
        for (int j = 0; j < total; ++j) {
          int m0, np;
          pair_origin(cid + (j / KS) * clusters, MT, NP, m0, np);
          const int k = (j % KS) * T_BK;
          if (lane == 0) {
            const int l = j % T_LS;
            mbar_wait(&l_empty[l], ((j / T_LS) & 1) ^ 1);
            mbar_arrive_expect_tx(&l_full[l], TiledSmem::LAND);
            tma_load_4d(land + l * TiledSmem::LAND, &qmap, &l_full[l], k,
                        (2 * np + (int)rank) * T_BN, 0, 0);
          } else {
            const int s = j % T_XS;
            mbar_wait(&x_empty[s], ((j / T_XS) & 1) ^ 1);
            mbar_arrive_expect_tx(&x_full[s], TiledSmem::X);
            tma_load_4d_multicast(
                xs + s * TiledSmem::X + rank * (TiledSmem::X / 2), &xmap,
                &x_full[s], k, m0 + rank * (T_BM / 2), 0x3);
          }
        }
      }
      __syncwarp();
    } else {
      // converters: int8 [128, 64] rows -> bf16 in the swizzled layout
      const int ctid = threadIdx.x - 256 - 32;
      for (int j = 0; j < total; ++j) {
        const int l = j % T_LS, w = j % T_WS;
        mbar_wait(&l_full[l], (j / T_LS) & 1);
        mbar_wait(&w_empty[w], ((j / T_WS) & 1) ^ 1);
        const unsigned char* src = land + l * TiledSmem::LAND;
        unsigned char* dst = wst + w * TiledSmem::WB;
#pragma unroll 2
        for (int idx = ctid; idx < T_BN * T_BK / 16; idx += T_CONVERTERS) {
          const int r = idx / (T_BK / 16);
          const int u = (idx % (T_BK / 16)) * 2;   // 16-byte unit in the row
          const uint4 raw = *reinterpret_cast<const uint4*>(src + idx * 16);
          uint32_t h[8];
          i8x4_to_bf16x4(raw.x, h[0], h[1]);
          i8x4_to_bf16x4(raw.y, h[2], h[3]);
          i8x4_to_bf16x4(raw.z, h[4], h[5]);
          i8x4_to_bf16x4(raw.w, h[6], h[7]);
          unsigned char* row = dst + r * 128;
          *reinterpret_cast<uint4*>(row + ((u ^ (r & 7)) << 4)) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(row + (((u + 1) ^ (r & 7)) << 4)) =
              make_uint4(h[4], h[5], h[6], h[7]);
        }
        fence_proxy_async();          // the stage is wgmma's to read
        named_bar_sync(1, T_CONVERTERS);
        if (ctid == 0) {              // one arrival for all: contended
          mbar_arrive(&l_empty[l]);   // arrivals serialise
          mbar_arrive(&w_full[w]);
        }
      }
    }
  } else {
    reg_alloc<216>();
    const int g = lane >> 2, t4 = lane & 3;
    // the weight is the A operand: warpgroup wg takes channels 64wg ..
    // 64wg + 63 of the tile against all 256 rows of x (the B operand);
    // acc[4jb + 0..1]: channel g, x rows 8jb + 2t + 0..1; acc[4jb + 2..3]:
    // channel g + 8
    float acc[128];
    int j = 0;
    for (int jt = 0; jt < mine; ++jt) {
      int m0, np;
      pair_origin(cid + jt * clusters, MT, NP, m0, np);
      const int n0 = (2 * np + (int)rank) * T_BN;
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] = 0.f;
      fence_operands<128>(acc);
      for (int ks = 0; ks < KS; ++ks, ++j) {
        const int s = j % T_XS, w = j % T_WS;
        mbar_wait(&x_full[s], (j / T_XS) & 1);
        mbar_wait(&w_full[w], (j / T_WS) & 1);
        const uint32_t xa = smem_u32(xs + s * TiledSmem::X);
        const uint32_t wa = smem_u32(wst + w * TiledSmem::WB) + wg * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < T_BK / 16; ++kc)
          mma_ss_n256<0>(acc, desc_kmajor(wa + kc * 32),
                         desc_kmajor(xa + kc * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands<128>(acc);
        __syncwarp();
        if (lane == 0) {              // this warp is done with both stages
          mbar_arrive(&x_empty[s]);
          mbar_arrive_cluster(&x_empty[s], rank ^ 1);
          mbar_arrive(&w_empty[w]);
        }
      }

      // epilogue: out[x row][channel]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + wg * 64 + warp * 16 + g + 8 * h;
        if (c >= N) continue;
        const float sc = scale[c];
#pragma unroll
        for (int jb = 0; jb < 32; ++jb) {
          const int m = m0 + jb * 8 + 2 * t4;
          if (m < M)
            out[(size_t)m * N + c] = __float2bfloat16(acc[4 * jb + 2 * h] * sc);
          if (m + 1 < M)
            out[(size_t)(m + 1) * N + c] =
                __float2bfloat16(acc[4 * jb + 2 * h + 1] * sc);
        }
      }
    }
  }
  cluster_sync();     // neither CTA leaves while the other may write to it
}

// ------------------------------------------------------------ host

// q [N, K] int8 as TMA sees it: the gemv form reads 128 x 128 boxes with
// the 128-byte swizzle, the tiled form 128 channels x 64 deep, unswizzled
int make_qmap(CUtensorMap* map, const void* q, int N, int K, int form) {
  const uint64_t dims[4] = {(uint64_t)K, (uint64_t)N, 1, 1};
  const int64_t strides[3] = {K, (int64_t)K * N, (int64_t)K * N};
  const uint32_t box_g[4] = {G_BK, G_BN, 1, 1};
  const uint32_t box_t[4] = {T_BK, T_BN, 1, 1};
  return make_map_box(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, dims, strides,
                      form == 0 ? box_g : box_t,
                      form == 0 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// each kernel's dynamic shared memory, raised once per device: before its
// launches and before the occupancy query that sizes its grid
template <int NG>
cudaError_t gemv_opt_in() {
  return smem_opt_in<w8_gemv_kernel<NG>>(GemvSmem<NG>::BYTES);
}

cudaError_t tiled_opt_in() {
  return smem_opt_in<w8_tiled_kernel>(TiledSmem::BYTES);
}

template <int NG>
int gemv_resident(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = gemv_opt_in<NG>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, w8_gemv_kernel<NG>, G_THREADS, GemvSmem<NG>::BYTES);
  *out = per_sm * sms;
  return (int)e;
}

template <int NG>
int launch_gemv(const CUtensorMap& qm, const bf16* x, const float* scale,
                bf16* out, int M, int N, int K, int ctas, float* ws,
                int* counters, cudaStream_t st) {
  constexpr int bytes = GemvSmem<NG>::BYTES;
  const cudaError_t e = gemv_opt_in<NG>();
  if (e != cudaSuccess) return (int)e;
  w8_gemv_kernel<NG><<<ctas, G_THREADS, bytes, st>>>(qm, x, scale, out, M, N,
                                                     K, ws, counters);
  return (int)cudaGetLastError();
}

// the tiled kernel's clusters of two (its __cluster_dims__) the device
// holds at once, as CTAs
int tiled_resident(int* out) {
  int clusters = 0;
  cudaError_t e = tiled_opt_in();
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(T_THREADS);
    cfg.dynamicSmemBytes = TiledSmem::BYTES;
    e = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(w8_tiled_kernel), &cfg);
  }
  *out = 2 * clusters;
  return (int)e;
}

int launch_tiled(const CUtensorMap& qm, const void* x, const float* scale,
                 bf16* out, int M, int N, int K, int ctas, cudaStream_t st) {
  if (ctas % 2 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap xm;
  const uint64_t dims[4] = {(uint64_t)K, (uint64_t)M, 1, 1};
  const int64_t strides[3] = {(int64_t)K * 2, (int64_t)K * M * 2,
                              (int64_t)K * M * 2};
  const uint32_t box[4] = {T_BK, T_BM / 2, 1, 1};   // one CTA's half
  const int err = make_map_box(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  constexpr int bytes = TiledSmem::BYTES;
  const cudaError_t e = tiled_opt_in();
  if (e != cudaSuccess) return (int)e;
  w8_tiled_kernel<<<ctas, T_THREADS, bytes, st>>>(xm, qm, scale, out, M, N,
                                                  K);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel F's TMA descriptor of q [N, K] (int8, contiguous, 16-byte
// aligned, K a multiple of 16) for `form` (0 = gemv, 1 = tiled), written to
// the 128 bytes at map_out. The host builds it once per weight and form.
extern "C" int mm_w8_qmap(const void* q, int N, int K, int form,
                          void* map_out) {
  if (N <= 0 || K <= 0 || K % 16 != 0 || (form != 0 && form != 1) ||
      map_out == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = make_qmap(&map, q, N, K, form);
  if (!err) memcpy(map_out, &map, sizeof(map));
  return err;
}

// CTAs of kernel F's `form` the current device holds at once, from the
// kernel's registers and shared memory, into *out: the gemv form for x
// tiles of 8 * ng rows (ng = 1, 2, 4 or 8), the tiled form in clusters of
// two.
extern "C" int mm_w8_resident(int form, int ng, int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  if (form == 1) return tiled_resident(out);
  if (form != 0) return (int)cudaErrorInvalidValue;
  switch (ng) {
    case 1: return gemv_resident<1>(out);
    case 2: return gemv_resident<2>(out);
    case 4: return gemv_resident<4>(out);
    case 8: return gemv_resident<8>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [M, K] bf16 and out [M, N] bf16, contiguous; qmap: mm_w8_qmap's bytes
// for this form; scale fp32 [N]; K a multiple of 16, x 16-byte aligned.
// form 0 = gemv (M <= 64): `ctas` CTAs share the (N / 128) x (K / 128)
// units out; ws holds 2 * ctas * 8 * ng * 128 floats (ng = 1, 2, 4, 8 for
// M <= 8, 16, 32, 64) and counters ceil(N / 128) ints, zero before the
// first launch (each launch leaves them zero).
// form 1 = tiled (any M): `ctas` (even) persistent CTAs in clusters of two
// over pairs of 128 x 256 output tiles; ws and counters unused.
// Returns a cudaError_t as int (0 = launched).
extern "C" int mm_w8_matmul(const void* x, const void* qmap,
                            const float* scale, void* out, int M, int N,
                            int K, int form, int ctas, float* ws,
                            int* counters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ctas <= 0 ||
      qmap == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  CUtensorMap qm;
  memcpy(&qm, qmap, sizeof(qm));
  if (form == 1) return launch_tiled(qm, x, scale, op, M, N, K, ctas, st);
  if (form != 0 || M > 64 || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M <= 8)
    return launch_gemv<1>(qm, xp, scale, op, M, N, K, ctas, ws, counters, st);
  if (M <= 16)
    return launch_gemv<2>(qm, xp, scale, op, M, N, K, ctas, ws, counters, st);
  if (M <= 32)
    return launch_gemv<4>(qm, xp, scale, op, M, N, K, ctas, ws, counters, st);
  return launch_gemv<8>(qm, xp, scale, op, M, N, K, ctas, ws, counters, st);
}
