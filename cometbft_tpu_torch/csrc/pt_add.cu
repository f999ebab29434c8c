// Complete twisted-Edwards point addition, lane-wise, one lane on a group
// of 4 threads, thread r holding coordinate r of (X:Y:Z:T).
//
// Replaces the Pallas kernel `pt_add_tiled`
// (cometbft_tpu/ops/pallas_verify.py:277, body `_pt_add_kernel` :272,
// formula `_pt_add` :134): add-2008-hwcd-3 on (4, 16, N) packed points.
//
// Bound on the H100: bytes. Each lane reads two points of 256 bytes and
// writes one (768 bytes) against 9 field multiplications, about 1,300
// 32-bit multiply-adds, which is under the card's ratio of int32
// multiply-adds to bytes of device memory (16.7e12 / 3.35e12, about 5
// per byte). At the A/B size of 8192 lanes the whole call moves 6.3 MB.
//
// Design: the one-thread design ran all 9 products of a lane on one
// thread (a chain of 3 dependent products, 9 in all) on 64 blocks of 4
// warps at 8192 lanes, so about half the SMs had no work and each busy
// one had a warp per scheduler to cover its loads and its chain. Here
// the formula is spread over the group as rlc_epilogue.cu's add4 spreads
// it: thread r loads coordinate r of P and of Q, forms one of A, B, D
// and C (C = T1 2d T2 is the one thread with two products), the group
// exchanges them by __shfl_sync (width 4), and thread r forms and stores
// coordinate r of (E F : G H : F G : E H). A thread's chain is 2 or 3
// products, and 8192 lanes are 256 blocks of 128 threads, one wave of 8
// warps per SM to overlap the loads. A warp covers 8 consecutive lanes,
// so each load and store of a limb row is four full 32-byte sectors
// (one per coordinate), lane-minor as in the JAX layout. Threads past n
// compute on zeros and skip only the store, since every shuffle takes
// the whole warp. The boundary is fe25519.cuh's: 16 limbs of 16 bits in
// int32, every limb in [0, 2^16), in and out.
// ptxas (sm_90a, -O3): 64 registers, no spills. On one NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py) 8,192 lanes take 0.0071 ms of device
// time, as the one-thread design does, and 8 lanes 0.0042 ms: most of
// the time is one lane's latency (launch, loads, 3 dependent field
// products, stores), which the one-thread design already overlapped
// across A, B, C and D. A shorter field product is what would move it.
#include <cuda_runtime.h>

#include "fe25519.cuh"

#define PT_ADD_THREADS 128
#define GROUP 4

// group thread src's value (the group is 4 consecutive lanes of the warp)
__device__ __forceinline__ fe fe_from(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.w[k] = __shfl_sync(0xffffffffu, a.w[k], src, GROUP);
  return r;
}

__global__ void __launch_bounds__(PT_ADD_THREADS)
pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
              int32_t* __restrict__ out, int n) {
  const long g = (long)blockIdx.x * PT_ADD_THREADS + threadIdx.x;
  const long lane = g / GROUP;
  const int r = (int)(g % GROUP);
  const bool live = lane < n;
  const long row = (long)r * 16 * n + lane;   // limb 0 of coordinate r
  fe c1 = fe_small(0), c2 = fe_small(0);
  if (live) {
    c1 = fe_load16(p + row, n);
    c2 = fe_load16(q + row, n);
  }
  const fe x1 = fe_from(c1, 0), y1 = fe_from(c1, 1);
  const fe x2 = fe_from(c2, 0), y2 = fe_from(c2, 1);
  // A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2), D = 2 Z1 Z2, C = T1 2d T2
  const fe u = r == 0 ? fe_sub(y1, x1)
                      : (r == 1 ? fe_add(y1, x1)
                                : (r == 3 ? fe_mul(c1, fe_2d()) : c1));
  const fe v = r == 0 ? fe_sub(y2, x2) : (r == 1 ? fe_add(y2, x2) : c2);
  fe w = fe_mul(u, v);
  if (r == 2) w = fe_add(w, w);
  const fe a = fe_from(w, 0), b = fe_from(w, 1);
  const fe d = fe_from(w, 2), c = fe_from(w, 3);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), gg = fe_add(d, c),
           h = fe_add(b, a);
  // coordinate r of (E F : G H : F G : E H)
  const fe o = fe_mul(r == 1 ? gg : (r == 2 ? f : e),
                      r == 0 ? f : (r == 2 ? gg : h));
  if (live) fe_store16(out + row, n, o);
}

// p, q, out: (4, 16, n) int32.
extern "C" int cbt_pt_add(const int32_t* p, const int32_t* q, int32_t* out,
                          int n, void* stream) {
  if (n > 0) {
    long threads = (long)n * GROUP;
    int blocks = (int)((threads + PT_ADD_THREADS - 1) / PT_ADD_THREADS);
    pt_add_kernel<<<blocks, PT_ADD_THREADS, 0, (cudaStream_t)stream>>>(
        p, q, out, n);
  }
  return (int)cudaGetLastError();
}
