// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax and
// accumulation, bf16 out plus an fp32 logsumexp.
//
// Replaces: the two Pallas TPU forward kernels of
//   metamorph_tpu/ops/flash_attention.py — `_fwd_kernel_tri` (driven by
//   `_fwd_tri`, the causal lower-triangle block list) and `_fwd_kernel`
//   (driven by `_fwd`, the rectangular grid, causal or not).
//   One kernel covers both: the TPU's triangle enumeration was a grid device
//   for a machine whose grid runs in order on one core; here each CTA loops
//   over its own k tiles and simply stops at the causal end.
//
// What bounds it on the H100: at prefill lengths (T >= 1024, Dh = 128) the
// score and PV products are ~2*T*Dh FLOPs per loaded key row, far above the
// card's ~295 FLOP/byte balance point, so the kernel is compute bound and
// the tensor cores (989 TFLOP/s bf16, reached only through wgmma) are the
// resource that matters.
//
// What the design does about it (helpers in sm90.cuh):
//   * one CTA per (q head, batch row, 128-row q tile): two consumer
//     warpgroups of 64 q rows each (wgmma's M) and a producer warpgroup of
//     which one thread issues TMA loads; `setmaxnreg` moves registers from
//     the producer (24) to the consumers (240);
//   * Q is loaded once by TMA; 128-key K/V tiles stream through a 2-stage
//     ring of shared-memory stages guarded by full/empty mbarriers, so the
//     next tile's load overlaps this tile's math; the producer stops at
//     min(length, causal end), so dead tiles cost neither loads nor math;
//   * S = Q K^T is a wgmma m64n128k16 with Q and K both read from shared
//     memory in the 128-byte swizzled layout TMA writes (K-major);
//   * online softmax in registers, in the log2 domain with the scale
//     applied in fp32; only tiles that cross the diagonal or the length are
//     masked;
//   * O += P V is a wgmma with P as the bf16 register A operand, converted
//     straight from the S accumulator, and V read from shared memory as an
//     MN-major (transposed) B operand;
//   * q tiles launch in reverse causal order (blockIdx.z counts down), so
//     the longest CTAs start first and the short ones fill the tail.
// GQA maps q head h to kv head h / (H / KV); K/V are never repeated.
//
// Semantics held to the Pallas kernels: key j is visible to query row i iff
// j < length[b] and (not causal or j <= i). Rows at or past length still
// attend to the valid keys. A row with no visible key gets o = 0 and
// lse = -1e30. Keys at or past the length inside the last tile are read
// (they are real memory, and must be finite) and get probability 0; keys
// past S and q rows past T arrive as zeros from TMA, which describes T (or
// S), heads and batch as separate dimensions. Inputs are addressed through
// strides, so the model layout [B, T, H, Dh] and the kernel layout
// [B, H, T, Dh] both work without copies.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;        // q rows per CTA: two consumer warpgroups
constexpr int BN = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.69314718055994530942f;

template <int D>
struct FwdSmem {
  static constexpr int Q = BM * D * 2;     // bytes of the Q tile
  static constexpr int KV = BN * D * 2;    // bytes of one K (or V) stage
  // Q, STAGES K and V stages, the barriers, and slack to align to 1024
  static constexpr int BYTES = Q + 2 * STAGES * KV + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ lengths, int H, int KV, int T, int S,
                 int64_t o_sb, int64_t o_sh, int64_t o_st, float scale_log2,
                 int causal) {
  constexpr int NCH = D / CHUNK;  // 64-column swizzle chunks of a row
  constexpr int QB = FwdSmem<D>::Q;
  constexpr int KVB = FwdSmem<D>::KV;
  constexpr int NS = BN / 2;      // S accumulator floats per thread
  constexpr int NO = D / 2;       // O accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + QB;
  unsigned char* vs = ks + STAGES * KVB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * KVB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // heaviest tiles first
  const int kvh = h / (H / KV);
  const int length = max(0, min(lengths[b], S));
  const int kv_end = causal ? min(length, q0 + BM) : length;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, QB);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(qs + c * BM * 128, &qmap, q_full, c * CHUNK, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * KVB);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(ks + s * KVB + c * BN * 128, &kmap, &full[s], c * CHUNK,
                      j * BN, kvh, b);
          tma_load_4d(vs + s * KVB + c * BN * 128, &vmap, &full[s], c * CHUNK,
                      j * BN, kvh, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;      // row within the 8-row half of a warp
    const int tig = lane & 3;     // column pair within an 8-column block
    const int row_lo = q0 + wg * 64;
    const int r0 = row_lo + warp * 16 + g;   // this thread's two q rows
    const int r1 = r0 + 8;
    // this warpgroup's 64 rows of each Q chunk
    const uint32_t qa = smem_u32(qs) + wg * 64 * 128;

    float oacc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
    float l[2] = {0.f, 0.f};               // partial sums over own columns

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint32_t ka = smem_u32(ks + s * KVB);
      const uint32_t va = smem_u32(vs + s * KVB);

      // S = Q K^T: 64 rows x 128 keys
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_ss<BN, 0>(sc,
                      desc_kmajor(qa + (kc / 4) * BM * 128 + (kc % 4) * 32),
                      desc_kmajor(ka + (kc / 4) * BN * 128 + (kc % 4) * 32),
                      1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<NS>(sc);

      // mask only a tile that crosses the length or the diagonal
      const int k0 = j * BN;
      if (k0 + BN > length || (causal && k0 + BN - 1 > row_lo)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = k0 + (i / 4) * 8 + tig * 2 + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (!(col < length && (!causal || col <= row))) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float ms[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with nothing visible yet keeps p = exp2(-inf) = 0
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        alpha[r] = exp2f(m[r] * scale_log2 - ms[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        l[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P from the S registers as the bf16 A operand, V MN-major
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
        pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        mma_rs<D, 1>(oacc, pa[kc], desc_mnmajor(va + kc * 16 * 128, BN * 128),
                     1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<NO>(oacc);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
    const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + tig * 2;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) =
            pack_bf16(oacc[4 * nb] * inv0, oacc[4 * nb + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) =
            pack_bf16(oacc[4 * nb + 2] * inv1, oacc[4 * nb + 3] * inv1);
    }
    if (tig == 0) {
      float* lb = lse + ((int64_t)b * H + h) * T;
      if (r0 < T)
        lb[r0] = l[0] > 0.f ? m[0] * scale_log2 * LN2 + logf(l[0]) : NEG_INF;
      if (r1 < T)
        lb[r1] = l[1] > 0.f ? m[1] * scale_log2 * LN2 + logf(l[1]) : NEG_INF;
    }
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, bf16* o,
               float* lse, const int* lengths, int B, int H, int KV, int T,
               int S, const int64_t* sd, float scale_log2, int causal,
               cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, D, T, H, B, sd[2], sd[1], sd[0], BM);
  if (!err) err = make_map(&km, k, D, S, KV, B, sd[5], sd[4], sd[3], BN);
  if (!err) err = make_map(&vm, v, D, S, KV, B, sd[8], sd[7], sd[6], BN);
  if (err) return err;
  constexpr int bytes = FwdSmem<D>::BYTES;
  const cudaError_t e = smem_opt_in<flash_fwd_kernel<D>>(bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (T + BM - 1) / BM);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, st>>>(
      qm, km, vm, o, lse, lengths, H, KV, T, S, sd[9], sd[10], sd[11],
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). Strides are in elements;
// layout-agnostic: pass the strides of the b, head and token dims.
extern "C" int mm_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* lengths, int B, int H, int KV, int T, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st,
    float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T <= 0 || S <= 0 ||
      B > 65535 || (T + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t sd[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                          v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float scale_log2 = scale * 1.44269504088896340736f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bf16* op = static_cast<bf16*>(o);
  if (D == 128)
    return launch_fwd<128>(q, k, v, op, lse, lengths, B, H, KV, T, S, sd,
                           scale_log2, causal, st);
  if (D == 64)
    return launch_fwd<64>(q, k, v, op, lse, lengths, B, H, KV, T, S, sd,
                          scale_log2, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
