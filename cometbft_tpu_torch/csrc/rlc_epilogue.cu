// RLC epilogue: fold the window partials, add the -R windows into the
// low -A windows, add the [S]B windows, radix-16 Horner, clear the
// cofactor, test for the identity. One block, one verdict.
//
// Replaces the Pallas kernel `rlc_epilogue`
// (cometbft_tpu/ops/pallas_verify.py:502, body `_epilogue_kernel` :452).
//
// Bound on the H100: operations, and in practice latency. The fold is
// 96 (M - 1) additions; the Horner is 63 x (4 doublings + 1 addition)
// plus 3 doublings, a chain that no number of lanes shortens: 255
// doublings are the floor of any radix-16 Horner over 64 windows.
//
// Design, in three phases of one block of 384 threads:
//   1. Fold: 4 threads per window. Thread q adds partials q, q + 4, ...
//      (the 4 threads of a window read neighbouring words), then two
//      __shfl_xor_sync steps fold the 4 sums: ceil(M/4) + 1 additions
//      deep, 3 = log2 M at the main path's M = 8. Any power-of-two M
//      runs, 1 and 128 included; missing partials are identity points.
//   2. Combine: one thread per -A window adds its -R window (windows
//      0..31) and its [S]B entry, then writes the point in the cached
//      form (Y - X, Y + X, 2Z, 2d T), so the Horner's additions pay no
//      2d T product. Windows live in shared memory (33-word rows, the
//      pad spreading a point's words over the banks).
//   3. Horner on one 4-lane group, lane r holding coordinate r of
//      (X:Y:Z:T). dbl-2008-hwcd squares X, Y, Z and X + Y on the four
//      lanes at once, then forms E F, G H, F G, E H at once; the
//      addition (add-2008-hwcd-3 against the cached point) forms A, B,
//      D, C at once, then the same four outputs. __shfl_sync moves the
//      intermediates within the group. A thread's chain is 2 field
//      products per doubling and per addition, where one thread running
//      the whole point pays 8 and 9. Lane 0 writes the verdict.
// ptxas (sm_90a, -O3): 168 registers, no spills (a 128-byte stack
// frame), 21,248 bytes of shared memory; the one block is 12 warps on one
// SM, and the Horner runs on one of them.
#include <cuda_runtime.h>

#include "fe25519.cuh"

#define A_WINDOWS 64
#define R_WINDOWS 32
#define N_WINDOWS 96
#define FOLD_LANES 4
#define EP_THREADS (N_WINDOWS * FOLD_LANES)
#define ROW 33                       // shared words per point

__device__ __forceinline__ fe fe_shfl_xor(const fe& a, int mask) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.w[k] = __shfl_xor_sync(0xffffffffu, a.w[k], mask);
  return r;
}

__device__ __forceinline__ ge ge_shfl_xor(const ge& p, int mask) {
  ge r;
  r.x = fe_shfl_xor(p.x, mask);
  r.y = fe_shfl_xor(p.y, mask);
  r.z = fe_shfl_xor(p.z, mask);
  r.t = fe_shfl_xor(p.t, mask);
  return r;
}

// lane src's value within the Horner's group (lanes 0..3 of warp 0)
__device__ __forceinline__ fe fe_from(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = __shfl_sync(0xfu, a.w[k], src, 4);
  return r;
}

// The common second half of both formulas: lane r returns coordinate r
// of (E F : G H : F G : E H).
__device__ __forceinline__ fe out4(const fe& e, const fe& f, const fe& g,
                                   const fe& h, int r) {
  return fe_mul(r == 1 ? g : (r == 2 ? f : e), r == 0 ? f : (r == 2 ? g : h));
}

// dbl-2008-hwcd; lane r holds coordinate r of the point.
__device__ __forceinline__ fe dbl4(const fe& c, int r) {
  fe x = fe_from(c, 0), y = fe_from(c, 1);
  fe s = fe_sq(r == 3 ? fe_add(x, y) : c);   // X^2, Y^2, Z^2, (X+Y)^2
  if (r == 2) s = fe_add(s, s);               // 2 Z^2
  fe a = fe_from(s, 0), b = fe_from(s, 1);
  fe h = fe_add(a, b), g = fe_sub(a, b);
  return out4(fe_sub(h, fe_from(s, 3)), fe_add(fe_from(s, 2), g), g, h, r);
}

// add-2008-hwcd-3; q is coordinate r of the cached point
// (Y2 - X2, Y2 + X2, 2 Z2, 2d T2).
__device__ __forceinline__ fe add4(const fe& c, const fe& q, int r) {
  fe x = fe_from(c, 0), y = fe_from(c, 1);
  fe u = fe_mul(r == 0 ? fe_sub(y, x) : (r == 1 ? fe_add(y, x) : c), q);
  fe a = fe_from(u, 0), b = fe_from(u, 1);   // A, B
  fe d = fe_from(u, 2), cc = fe_from(u, 3);  // D = 2 Z1 Z2, C = T1 2d T2
  return out4(fe_sub(b, a), fe_sub(d, cc), fe_add(d, cc), fe_add(b, a), r);
}

__global__ void __launch_bounds__(EP_THREADS, 1)
rlc_epilogue_kernel(const int32_t* __restrict__ folded,
                    const int32_t* __restrict__ b_tab,
                    const int32_t* __restrict__ s_dig,
                    uint8_t* __restrict__ ok, int m) {
  __shared__ uint32_t win[N_WINDOWS][ROW];     // window sums, extended
  __shared__ uint32_t cached[A_WINDOWS][ROW];  // combined, cached form
  __shared__ uint32_t top[32];                 // window 63, extended
  const int tid = threadIdx.x;

  {  // phase 1: fold; folded is (4, 16, 96, m)
    const int w = tid / FOLD_LANES, q = tid % FOLD_LANES;
    const long limb_stride = (long)N_WINDOWS * m;
    ge acc = ge_identity();
#pragma unroll 1
    for (int j = q; j < m; j += FOLD_LANES) {
      ge p = ge_load16(folded + (long)w * m + j, limb_stride);
      acc = j == q ? p : ge_add(acc, p);
    }
    acc = ge_add(acc, ge_shfl_xor(acc, 2));
    acc = ge_add(acc, ge_shfl_xor(acc, 1));
    if (q == 0) ge_store_words(win[w], 1, acc);
  }
  __syncthreads();
  if (tid < A_WINDOWS) {  // phase 2: combine, [S]B, cached form
    ge p = ge_load_words(win[tid], 1);
    if (tid < R_WINDOWS)
      p = ge_add(p, ge_load_words(win[A_WINDOWS + tid], 1));
    // b_tab is (16, 4, 16): entry d, coord c, limb l at d*64 + c*16 + l
    p = ge_add(p, ge_load16(b_tab + (s_dig[tid] & 15) * 64, 1));
    fe_store_words(cached[tid], 1, fe_sub(p.y, p.x));
    fe_store_words(cached[tid] + 8, 1, fe_add(p.y, p.x));
    fe_store_words(cached[tid] + 16, 1, fe_add(p.z, p.z));
    fe_store_words(cached[tid] + 24, 1, fe_mul(p.t, fe_2d()));
    if (tid == A_WINDOWS - 1) ge_store_words(top, 1, p);  // Horner's start
  }
  __syncthreads();
  if (tid >= FOLD_LANES) return;

  // phase 3: Horner on lanes 0..3. The loops keep one copy of each
  // formula's code, which one warp walks 318 times. Straight-line code
  // for a window's 4 doublings and addition ran 2.4x slower on the card
  // (1.026 against 0.424 ms at M = 8); instruction fetch is the likely
  // cause, not yet shown by a stall profile.
  const int r = tid;
  fe c = fe_load_words(top + 8 * r, 1);
#pragma unroll 1
  for (int i = A_WINDOWS - 2; i >= -1; i--) {
#pragma unroll 1
    for (int k = i >= 0 ? 0 : 1; k < 4; k++) c = dbl4(c, r);
    if (i >= 0) c = add4(c, fe_load_words(cached[i] + 8 * r, 1), r);
  }
  ge v;
  v.x = fe_from(c, 0);
  v.y = fe_from(c, 1);
  v.z = fe_from(c, 2);
  v.t = fe_from(c, 3);
  if (r == 0) ok[0] = ge_is_identity(v) ? 1 : 0;
}

// folded: (4, 16, 96, m) int32, m a power of two; b_tab: (16, 4, 16)
// int32; s_dig: (64,) int32; ok: (1,) bool.
extern "C" int cbt_rlc_epilogue(const int32_t* folded, const int32_t* b_tab,
                                const int32_t* s_dig, uint8_t* ok, int m,
                                void* stream) {
  rlc_epilogue_kernel<<<1, EP_THREADS, 0, (cudaStream_t)stream>>>(
      folded, b_tab, s_dig, ok, m);
  return (int)cudaGetLastError();
}
