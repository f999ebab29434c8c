// RLC window sums: per-lane window tables, digit selection, and a sum
// over each 1024-lane chunk, one partial point per (chunk, window).
//
// Replaces the Pallas kernel `rlc_window_sums`
// (cometbft_tpu/ops/pallas_verify.py:351, body `_rlc_kernel` :331).
//
// Bound on the H100: operations. Per lane, the tables [j](-A) and [j](-R),
// j = 0..15, take at least 7 doublings and 7 additions each (the odd
// entries are additions, the even ones doublings); then each of the 96
// windows is summed over the lanes (N - G additions per window, G
// chunks). About 110 additions of 9 field multiplications and 14
// doublings of 4 squarings and 4 multiplications per lane, against 896
// bytes read per lane.
//
// Design: two launches from one host call.
//   1. rlc_tables_kernel: 8 threads per (lane, table), 16 lanes of one
//      table per block. The entries double up in four steps, each one
//      point operation deep: [2] = 2[1]; [3] = [2] + [1], [4] = 2[2];
//      [5], [7] = [4] + [1], [3] and [6], [8] = 2[3], 2[4]; [9..15 odd]
//      = [8] + [1..7 odd] and [10..14 even] = 2[5..7], so a table is 4
//      operations deep where one thread building it alone is 14. A warp
//      holds two of a block's 8 slots (16 lanes each), and each step
//      gives the additions and the doublings to different warps, so no
//      warp runs both formulas. The entries live in shared memory, entry
//      by entry with the 16 lanes side by side (33-word rows: the pad
//      spreads a point's words over the banks), and the block writes its
//      16 lanes' tables out as one contiguous, coalesced run. The tables
//      go to a global scratch buffer the wrapper allocates, laid out
//      [table][lane][entry][32 words]: 32 MiB at 8192 lanes, which stays
//      in the 50 MB L2, and an entry is one aligned 128-byte line, so a
//      selection reads whole lines (8 x 16-byte loads) whatever the digit.
//   2. rlc_window_sums_kernel: a grid of (chunk, window) blocks of 128
//      threads. Each thread adds the selected entries of a strip of 8
//      lanes (lane, lane + 128, ...; each step a warp reads 32 digits
//      side by side); a warp tree of __shfl_down_sync over a point's 32
//      words folds the strips, and warp 0 folds the 4 warps' sums. The
//      chain is 7 + 5 + 2 = 14 additions; at 8192 lanes the grid is
//      8 x 96 = 768 blocks, every thread busy until the warp steps.
// ptxas (sm_90a, -O3): the table kernel 96 registers, no spills,
// 33,792 bytes of shared memory, so 5 blocks (20 warps) fit on an SM;
// the sum kernel 128 registers (its launch bound), 36 bytes spilled, so
// 4 blocks (16 warps) fit on an SM.
// Selection indexes the table by the digit directly; the TPU's
// compare-and-accumulate over all 16 entries was a vectorisation device.
// The digits come from z, which is drawn after the batch is fixed, so
// the access pattern leaks nothing a signer controls. Blocks run in any
// order, so each writes its own partial, (G, 96, 4, 16, 1), and the
// epilogue folds them. Lanes past n are identity points: the last chunk
// and the last table block mask their own ragged edge.
#include <cuda_runtime.h>

#include "fe25519.cuh"

#define A_WINDOWS 64
#define R_WINDOWS 32
#define N_WINDOWS 96
#define TAB_LANES 16                      // lanes of one table per block
#define TAB_THREADS (TAB_LANES * 8)       // 8 threads per (lane, table)
#define TAB_ROW 33                        // shared words per entry
#define WS_THREADS 128
#define WS_STRIP 8                        // lanes each thread adds
#define WS_CHUNK (WS_THREADS * WS_STRIP)  // lanes per partial: LANE_TILE

__global__ void __launch_bounds__(TAB_THREADS)
rlc_tables_kernel(const int32_t* __restrict__ a_pt,
                  const int32_t* __restrict__ r_pt,
                  uint32_t* __restrict__ tables, int n) {
  __shared__ uint32_t tab[16 * TAB_LANES][TAB_ROW];  // row e * 16 + lane
  const int tid = threadIdx.x, g = tid % TAB_LANES, s = tid / TAB_LANES;
  const int l0 = blockIdx.x * TAB_LANES, lane = l0 + g;
  const int table = blockIdx.y;
  const bool live = lane < n;
  uint32_t(*entry)[TAB_ROW] = tab + g;  // entry e of this lane: entry[16 e]

  if (live && s == 0) ge_store_words(entry[0], 1, ge_identity());
  if (live && s == 1)
    ge_store_words(entry[TAB_LANES], 1,
                   ge_load16((table ? r_pt : a_pt) + lane, n));
  __syncthreads();
  // Step b fills [b+1 .. min(2b, 15)]: slots s < b/2 the odd entries
  // [b] + [e - b], slots from max(b/2, 2) on the even ones 2[e/2].
  for (int b = 1; b < 16; b <<= 1) {
    const int s_dbl = max(b / 2, 2);
    const int e = s < b / 2 ? b + 1 + 2 * s
                            : ((b + 2) & ~1) + 2 * (s - s_dbl);
    if (live && s < b / 2)
      ge_store_words(entry[TAB_LANES * e], 1,
                     ge_add(ge_load_words(entry[TAB_LANES * b], 1),
                            ge_load_words(entry[TAB_LANES * (e - b)], 1)));
    else if (live && s >= s_dbl && e <= min(2 * b, 15))
      ge_store_words(entry[TAB_LANES * e], 1,
                     ge_dbl(ge_load_words(entry[TAB_LANES * (e / 2)], 1)));
    __syncthreads();
  }
  const int lanes = min(TAB_LANES, n - l0);
  uint32_t* dst = tables + ((long)table * n + l0) * 16 * 32;
  for (int i = tid; i < lanes * 16 * 32; i += TAB_THREADS)  // lane, entry
    dst[i] = tab[((i >> 5) & 15) * TAB_LANES + (i >> 9)][i & 31];
}

__device__ __forceinline__ fe fe_load_vec(const uint4* v) {
  uint4 a = v[0], b = v[1];
  fe r = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  return r;
}

// one table entry: 32 words, X Y Z T, from one 128-byte line
__device__ __forceinline__ ge ge_load_entry(const uint32_t* e) {
  const uint4* v = reinterpret_cast<const uint4*>(e);
  ge p;
  p.x = fe_load_vec(v);
  p.y = fe_load_vec(v + 2);
  p.z = fe_load_vec(v + 4);
  p.t = fe_load_vec(v + 6);
  return p;
}

__device__ __forceinline__ fe fe_shfl_down(const fe& a, int off) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.w[k] = __shfl_down_sync(0xffffffffu, a.w[k], off);
  return r;
}

__device__ __forceinline__ ge ge_shfl_down(const ge& p, int off) {
  ge r;
  r.x = fe_shfl_down(p.x, off);
  r.y = fe_shfl_down(p.y, off);
  r.z = fe_shfl_down(p.z, off);
  r.t = fe_shfl_down(p.t, off);
  return r;
}

__global__ void __launch_bounds__(WS_THREADS, 4)
rlc_window_sums_kernel(const uint32_t* __restrict__ tables,
                       const int32_t* __restrict__ t_dig,
                       const int32_t* __restrict__ z_dig,
                       int32_t* __restrict__ out, int n) {
  __shared__ ge warp_sum[WS_THREADS / 32];
  const int tid = threadIdx.x, w = blockIdx.y;
  const int table = w >= A_WINDOWS;
  const int32_t* dig = table ? z_dig + (long)(w - A_WINDOWS) * n
                             : t_dig + (long)w * n;
  const uint32_t* tab = tables + (long)table * n * 16 * 32;
  const int first = blockIdx.x * WS_CHUNK + tid;

  // lanes rise with k, so once one is past n all later ones are too
  ge acc = ge_identity();
#pragma unroll 1
  for (int k = 0; k < WS_STRIP; k++) {
    const int lane = first + k * WS_THREADS;
    if (lane < n) {
      ge p = ge_load_entry(tab + ((long)lane * 16 + (dig[lane] & 15)) * 32);
      acc = k == 0 ? p : ge_add(acc, p);
    }
  }
#pragma unroll 1
  for (int off = 16; off > 0; off >>= 1)
    acc = ge_add(acc, ge_shfl_down(acc, off));
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    acc = tid < WS_THREADS / 32 ? warp_sum[tid] : ge_identity();
#pragma unroll 1
    for (int off = WS_THREADS / 64; off > 0; off >>= 1)
      acc = ge_add(acc, ge_shfl_down(acc, off));
    if (tid == 0)
      ge_store16(out + ((long)blockIdx.x * N_WINDOWS + w) * 64, 1, acc);
  }
}

// a_pt, r_pt: (4, 16, n) int32; t_dig: (64, n); z_dig: (32, n) int32;
// out: (g, 96, 4, 16, 1) int32 with g = ceil(n / WS_CHUNK);
// scratch: (2, n, 16, 32) uint32, the tables. Two launches.
extern "C" int cbt_rlc_window_sums(const int32_t* a_pt, const int32_t* r_pt,
                                   const int32_t* t_dig, const int32_t* z_dig,
                                   int32_t* out, uint32_t* scratch, int n,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 tab_grid((n + TAB_LANES - 1) / TAB_LANES, 2);
  rlc_tables_kernel<<<tab_grid, TAB_THREADS, 0, s>>>(a_pt, r_pt, scratch, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid((n + WS_CHUNK - 1) / WS_CHUNK, N_WINDOWS);
  rlc_window_sums_kernel<<<grid, WS_THREADS, 0, s>>>(scratch, t_dig, z_dig,
                                                     out, n);
  return (int)cudaGetLastError();
}
