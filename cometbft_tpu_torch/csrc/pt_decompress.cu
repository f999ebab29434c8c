// ZIP-215 point decompression, one thread per lane.
//
// Replaces the Pallas kernel `pt_decompress_tiled`
// (cometbft_tpu/ops/pallas_verify.py:411, body `_decompress` :241).
//
// Bound on the H100: operations. Each lane runs 255 field squarings (the
// 251 of fe_pow2523's ref10 chain, 4 in the decode) and 19 or 20 field
// multiplications, against 388 bytes moved (32 int32 bytes in, a (4, 16)
// int32 point and a flag out). A multiplication is 64 32x32->64-bit
// multiply-adds; a squaring needs only its 36 distinct products, and
// fe_sq pays just those.
//
// Design: the whole chain stays in registers; lanes are independent, so
// a block is just 128 consecutive lanes and the grid covers the ragged
// edge with a bounds check. Loads and stores are lane-minor (the JAX
// layout), so a warp reads and writes 128 contiguous bytes per limb.
#include <cuda_runtime.h>

#include "fe25519.cuh"

#define DECOMPRESS_THREADS 128

__global__ void __launch_bounds__(DECOMPRESS_THREADS)
pt_decompress_kernel(const int32_t* __restrict__ enc, int32_t* __restrict__ pt,
                     uint8_t* __restrict__ ok, int n) {
  int lane = blockIdx.x * DECOMPRESS_THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  bool valid = ge_decompress(enc + lane, n, &p);
  ge_store16(pt + lane, n, p);
  ok[lane] = valid ? 1 : 0;
}

// enc: (32, n) int32 bytes; pt: (4, 16, n) int32; ok: (n,) bool.
extern "C" int cbt_pt_decompress(const int32_t* enc, int32_t* pt, uint8_t* ok,
                                 int n, void* stream) {
  if (n > 0) {
    int blocks = (n + DECOMPRESS_THREADS - 1) / DECOMPRESS_THREADS;
    pt_decompress_kernel<<<blocks, DECOMPRESS_THREADS, 0,
                           (cudaStream_t)stream>>>(enc, pt, ok, n);
  }
  return (int)cudaGetLastError();
}
