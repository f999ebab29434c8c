// Complete twisted-Edwards point addition, lane-wise, one thread per lane.
//
// Replaces the Pallas kernel `pt_add_tiled`
// (cometbft_tpu/ops/pallas_verify.py:277, body `_pt_add_kernel` :272,
// formula `_pt_add` :134): add-2008-hwcd-3 on (4, 16, N) packed points.
//
// Bound on the H100: bytes. Each lane reads two points of 256 bytes and
// writes one (768 bytes) against 9 field multiplications, about 1,300
// 32-bit multiply-adds, which is under the card's ratio of int32
// multiply-adds to bytes of device memory (16.7e12 / 3.35e12, about 5
// per byte). At the A/B size of 8192 lanes the whole call moves 6.3 MB,
// so it sits near launch latency.
//
// Design: lanes are independent, so a block is 128 consecutive lanes and
// the grid covers the ragged edge with a bounds check (the Pallas entry
// needed N % TILE == 0; this one takes any N). Loads and stores are
// lane-minor, the JAX layout, so a warp reads and writes 128 contiguous
// bytes per limb. The arithmetic is `ge_add` of fe25519.cuh, the same
// addition rlc_window_sums builds its tables and tree with; the
// boundary is fe25519.cuh's: 16 limbs of 16 bits in int32, every limb in
// [0, 2^16), in and out.
#include <cuda_runtime.h>

#include "fe25519.cuh"

#define PT_ADD_THREADS 128

__global__ void __launch_bounds__(PT_ADD_THREADS)
pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
              int32_t* __restrict__ out, int n) {
  int lane = blockIdx.x * PT_ADD_THREADS + threadIdx.x;
  if (lane >= n) return;
  ge_store16(out + lane, n,
             ge_add(ge_load16(p + lane, n), ge_load16(q + lane, n)));
}

// p, q, out: (4, 16, n) int32.
extern "C" int cbt_pt_add(const int32_t* p, const int32_t* q, int32_t* out,
                          int n, void* stream) {
  if (n > 0) {
    int blocks = (n + PT_ADD_THREADS - 1) / PT_ADD_THREADS;
    pt_add_kernel<<<blocks, PT_ADD_THREADS, 0, (cudaStream_t)stream>>>(
        p, q, out, n);
  }
  return (int)cudaGetLastError();
}
