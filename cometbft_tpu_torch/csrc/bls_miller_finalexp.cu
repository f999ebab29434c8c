// The fused aggregate-commit check per lane: final_exp(prod miller) and its
// verdict == 1.
//
// Replaces the JAX package's jitted program `_compiled_miller`
// (cometbft_tpu/ops/bls12.py:521; body :523-527), behind
// `miller_finalexp_is_one_batch`. Its input is the host-evaluated line
// coefficients in the JAX layout, (63, 2, 2, 3, 2, 24, B) int32 16-bit
// Montgomery limbs (step, pair, doubling/addition phase, sparse coefficient
// c0/c3/c5, Fq2 component, limb, lane), with identity lines in zero-bit
// addition slots, absent pairs and pad lanes. Per lane it computes what the
// JAX program does:
//   1. the shared-squaring Miller scan: f = 1; per step one Fq12 squaring
//      and four sparse line products (2 pairs x 2 phases); then f = conj(f)
//      (x is negative);
//   2. the easy part: m = conj(f) * f^-1, then m = frob2(m) * m, with the
//      inversion through the Fq6 tower and a Fermat Fq inversion, and the
//      p^2-Frobenius as six Fq scalings;
//   3. the hard part, the bits of bls_hard_pow.cu, from a device tensor.
// It writes the final Fq12 element in canonical limbs, (6, 2, 24, B), and
// the verdict, so it can be held exactly against the plain version
// (ops/bls12.bls_miller_finalexp_plain).
//
// Bound on the H100: operations, each at its least as in bls_hard_pow.cu
// (chip_smoke.py `_bls_mads`). Per lane: the scan's squarings after the
// first (57 Fq products each) and its lines that are not the identity,
// all but the first (a 2-pair lane has 126 doubling and 10 addition lines
// of the 252 slots; 54 Fq products each); the easy part's two Fq12
// products, 8 Fq products of the Frobenius and the inversion (~120 Fq
// products and a Fermat chain of 380 squarings and 228 products, Fq
// squarings at 444 int32 multiply-adds); the hard chain's 632
// multiplies and 1,267 squarings, which after the easy part are
// cyclotomic (18 Fq products each). The lines are 4.6 MB at B = 64, a
// few microseconds of memory traffic.
//
// Design: one lane on one block of 64 threads, the Fq12 products spread
// over the block as in bls_hard_pow.cu (fq381.cuh's block section). The
// inversion runs on one thread (f12_inv_serial): ~720 dependent Fq
// products, about a tenth of the lane's latency. Six threads load each
// step's line from device memory into shared memory.
// ptxas (sm_90a, -O3): 255 registers, a 2,528-byte stack (the serial
// inversion's out-of-line products), 5,472 bytes of shared memory. On one
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) a call takes 17.0, 18.1
// and 19.2 ms of device time at B = 4, 16 and 64, against bounds of
// 0.014, 0.056 and 0.225 ms.
#include <cuda_runtime.h>

#include "fq381.cuh"

#define MILLER_STEPS 63
#define MILLER_PAIRS 2

__global__ void __launch_bounds__(BLS_THREADS)
bls_miller_finalexp_kernel(const int32_t* __restrict__ lines,
                           const int32_t* __restrict__ bits, int nbits,
                           int32_t* __restrict__ out,
                           uint8_t* __restrict__ ok, int b) {
  __shared__ fq2 f[6], m[6], inv[6], line[3], prod[36];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 6) {
    f[t].c0 = t == 0 ? fq_one() : fq_zero();
    f[t].c1 = fq_zero();
  }
  __syncthreads();
  // 1. the Miller scan
  for (int s = 0; s < MILLER_STEPS; s++) {
    f12_mul_block(f, f, f, 6, prod);
    for (int pi = 0; pi < MILLER_PAIRS; pi++) {
      for (int ph = 0; ph < 2; ph++) {
        if (t < 6) {
          const long row =
              ((((long)(s * MILLER_PAIRS + pi) * 2 + ph) * 3 + (t >> 1)) * 2 +
               (t & 1)) * 24;
          const fq v = fq_load16(lines + row * b + lane, b);
          if (t & 1) line[t >> 1].c1 = v;
          else line[t >> 1].c0 = v;
        }
        __syncthreads();
        f12_mul_block(f, f, line, 3, prod);
      }
    }
  }
  if (t < 6 && (t & 1)) f[t] = fq2_neg(f[t]);   // f = conj(f)
  __syncthreads();
  // 2. the easy part
  if (t == 0) f12_inv_serial(f, inv);
  if (t < 6) m[t] = (t & 1) ? fq2_neg(f[t]) : f[t];
  __syncthreads();
  f12_mul_block(m, m, inv, 6, prod);            // conj(f) * f^-1
  if (t < 12) {
    const fq g = fq_gamma2(t >> 1);
    if (t & 1) f[t >> 1].c1 = fq_mul(m[t >> 1].c1, g);
    else f[t >> 1].c0 = fq_mul(m[t >> 1].c0, g);
  }
  __syncthreads();
  f12_mul_block(m, f, m, 6, prod);              // frob2(m) * m
  // 3. the hard part
  if (t < 6) f[t] = m[t];
  __syncthreads();
  f12_pow_block(f, m, bits, nbits, prod);
  f12_store_block(out, ok, f, lane, b);
}

extern "C" int cbt_bls_miller_finalexp(const int32_t* lines,
                                       const int32_t* bits, int nbits,
                                       int32_t* out, uint8_t* ok, int b,
                                       void* stream) {
  if (b > 0)
    bls_miller_finalexp_kernel<<<b, BLS_THREADS, 0, (cudaStream_t)stream>>>(
        lines, bits, nbits, out, ok, b);
  return (int)cudaGetLastError();
}
