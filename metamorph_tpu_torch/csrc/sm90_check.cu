// A unit check of sm90.cuh for the card tests (not on any main path): one
// warpgroup loads A [64, 128] and B by TMA with the 128-byte swizzle and
// computes C [64, N] = A B with eight wgmma m64nNk16 steps, through the same
// tensor maps, descriptors and accumulator layout that kernels A and D use.
//   mode bit 0: B is MN-major, given as [128, N] row-major (else K-major,
//               given as [N, 128] row-major, C = A B^T of it);
//   mode bit 1: A from registers (fragments loaded from global memory in
//               the m16n8k16 A layout) instead of shared memory.
// The test compares C with torch.matmul in fp32.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int KD = 128;   // the product's depth: two swizzle chunks

template <int N>
__global__ void __launch_bounds__(128)
sm90_check_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const bf16* __restrict__ a, float* __restrict__ c, int mode) {
  constexpr int AB = 64 * KD * 2;
  constexpr int BB = N * KD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bs = as + AB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + BB);
  const bool mn = mode & 1;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, AB + BB);
    for (int ch = 0; ch < KD / CHUNK; ++ch)
      tma_load_4d(as + ch * 64 * 128, &amap, bar, ch * CHUNK, 0, 0, 0);
    if (mn) {   // [128 rows of depth, N columns]: N / 64 chunks of 128 rows
      for (int ch = 0; ch < N / CHUNK; ++ch)
        tma_load_4d(bs + ch * KD * 128, &bmap, bar, ch * CHUNK, 0, 0, 0);
    } else {    // [N rows, 128 columns of depth]: two chunks of N rows
      for (int ch = 0; ch < KD / CHUNK; ++ch)
        tma_load_4d(bs + ch * N * 128, &bmap, bar, ch * CHUNK, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;
  const uint32_t aa = smem_u32(as), ba = smem_u32(bs);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KD / 16; ++kc) {
    const uint64_t db =
        mn ? desc_mnmajor(ba + kc * 16 * 128, KD * 128)
           : desc_kmajor(ba + (kc / 4) * N * 128 + (kc % 4) * 32);
    if (mode & 2) {
      const int k = kc * 16 + tig * 2;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(a + r0 * KD + k);
      af[1] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * KD + k);
      af[2] = *reinterpret_cast<const uint32_t*>(a + r0 * KD + k + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * KD + k + 8);
      if (mn) mma_rs<N, 1>(acc, af, db, 1);
      else mma_rs<N, 0>(acc, af, db, 1);
    } else {
      const uint64_t da = desc_kmajor(aa + (kc / 4) * 64 * 128 + (kc % 4) * 32);
      if (mn) mma_ss<N, 1>(acc, da, db, 1);
      else mma_ss<N, 0>(acc, da, db, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands<N / 2>(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + ((i & 2) ? 8 : 0);
    const int col = (i / 4) * 8 + tig * 2 + (i & 1);
    c[row * N + col] = acc[i];
  }
}

template <int N>
int launch_check(const void* a, const void* b, float* c, int mode,
                 cudaStream_t st) {
  CUtensorMap am, bm;
  int err = make_map(&am, a, KD, 64, 1, 1, KD, 0, 0, 64);
  if (!err)
    err = (mode & 1) ? make_map(&bm, b, N, KD, 1, 1, N, 0, 0, KD)
                     : make_map(&bm, b, KD, N, 1, 1, KD, 0, 0, N);
  if (err) return err;
  constexpr int bytes = 64 * KD * 2 + N * KD * 2 + 64 + 1024;
  const cudaError_t e = smem_opt_in<sm90_check_kernel<N>>(bytes);
  if (e != cudaSuccess) return (int)e;
  sm90_check_kernel<N><<<1, 128, bytes, st>>>(
      am, bm, static_cast<const bf16*>(a), c, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// C [64, N] fp32 = A [64, 128] bf16 times B (see the header); N is 64 or
// 128. Returns a cudaError_t as int.
extern "C" int mm_sm90_desc_check(const void* a, const void* b, float* c,
                                  int N, int mode, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (N == 64) return launch_check<64>(a, b, c, mode, st);
  if (N == 128) return launch_check<128>(a, b, c, mode, st);
  return (int)cudaErrorInvalidValue;
}
