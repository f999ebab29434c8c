// ZIP-215 point decompression, one lane's field arithmetic split over a
// group of 4 threads (fe25519_group.cuh).
//
// Replaces the Pallas kernel `pt_decompress_tiled`
// (cometbft_tpu/ops/pallas_verify.py:411, body `_decompress` :241).
//
// Bound on the H100: operations. Each lane runs 255 field squarings (the
// 251 of the ref10 chain of z^((p-5)/8), 4 in the decode) and 19 or 20
// field multiplications, against 388 bytes moved (32 int32 bytes in, a
// (4, 16) int32 point and a flag out). In practice the bound is the
// chain's latency: 274 dependent field operations per lane, which no
// number of lanes shortens.
//
// Design: the one-thread design ran each lane's chain on one thread, so
// at 8192 lanes the grid was 64 blocks of 4 warps, 68 of the 132 SMs got
// no work, and each busy SM had one warp per scheduler to hide a
// dependent chain of multiply-adds behind. Here a lane is 4 consecutive
// threads, thread r holding words 2r, 2r+1 of every element, and the
// caller decodes A and R in one call: at the main path's 2 x 8192 lanes
// the grid is 512 blocks of 128 threads (32 lanes a block), about 15
// warps per SM. Each field operation is a 2 x 8 schoolbook per thread
// plus shuffles and ballots within the group (see the header), so a
// thread issues more instructions per operation than the one-thread
// fe_sq, and the card has 4x the warps to interleave them. Threads past
// n decode a zero encoding and skip only the stores, since every
// shuffle and ballot takes the whole warp. Loads and stores stay
// lane-minor: a warp covers 8 consecutive lanes, so each access is four
// full 32-byte sectors (one per group thread's limb row).
// ptxas (sm_90a, -O3): 48 registers, no spills, no stack. On one NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py) a call of 16,384 lanes takes
// 0.119 ms of device time, the one-thread design's two launches of 8,192
// 0.203 ms; 8,192 lanes take 0.071 ms, so at 16,384 the kernel is
// mostly throughput-bound (15 shuffles a field product per thread).
#include <cuda_runtime.h>

#include "fe25519_group.cuh"

#define DECOMPRESS_THREADS 128
#define GROUP 4

__global__ void __launch_bounds__(DECOMPRESS_THREADS)
pt_decompress_kernel(const int32_t* __restrict__ enc, int32_t* __restrict__ pt,
                     uint8_t* __restrict__ ok, int n) {
  const long g = (long)blockIdx.x * DECOMPRESS_THREADS + threadIdx.x;
  const long lane = g / GROUP;
  const int r = (int)(g % GROUP);
  const bool live = lane < n;
  uint64_t y = 0;
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; j++)
      y |= (uint64_t)((uint32_t)enc[(8 * r + j) * (long)n + lane] & 0xffu)
           << (8 * j);
  }
  uint64_t x, t;
  const bool valid = grp_decompress(y, r, &x, &y, &t);
  if (!live) return;
  const uint64_t one = grp_small(1, r);
  const uint64_t c[4] = {x, y, one, t};
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int q = 0; q < 4; q++)
      pt[(k * 16 + 4 * r + q) * (long)n + lane] =
          (int32_t)((c[k] >> (16 * q)) & 0xffffu);
  if (r == 0) ok[lane] = valid ? 1 : 0;
}

// enc: (32, n) int32 bytes; pt: (4, 16, n) int32; ok: (n,) bool.
extern "C" int cbt_pt_decompress(const int32_t* enc, int32_t* pt, uint8_t* ok,
                                 int n, void* stream) {
  if (n > 0) {
    long threads = (long)n * GROUP;
    int blocks =
        (int)((threads + DECOMPRESS_THREADS - 1) / DECOMPRESS_THREADS);
    pt_decompress_kernel<<<blocks, DECOMPRESS_THREADS, 0,
                           (cudaStream_t)stream>>>(enc, pt, ok, n);
  }
  return (int)cudaGetLastError();
}
