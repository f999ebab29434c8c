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
//   2. the easy part: m = conj(f) * f^-1, then m = frob2(m) * m;
//   3. the hard part, the bits of bls_hard_pow.cu, from a device tensor.
// It writes the final Fq12 element in canonical limbs, (6, 2, 24, B), and
// the verdict, so it can be held exactly against the plain version
// (ops/bls12.bls_miller_finalexp_plain).
//
// Bound on the H100: operations, each at its least (chip_smoke.py
// `_bls_mads`): the scan's squarings after the first and its lines that
// are not the identity, the easy part, and the windowed hard chain below
// with cyclotomic squarings (18 Fq products each). The lines are 4.6 MB at B = 64, a few microseconds of memory
// traffic.
//
// Design (fq381.cuh, block code): one lane on one block of 128 threads,
// each Fq12 operation a product phase (one Fq product a thread) and a fold
// phase. The scan: a general squaring (63 Fq products) and the step's live
// lines (54 each): a slot whose line is ONE (a zero-bit addition, an
// absent pair, a pad lane: 116 of a 2-pair lane's 252) is skipped, which is
// exact. Step s + 1's lines are copied into a second shared buffer with
// cp.async while step s computes, so no barrier waits on device memory.
// The easy part as f^2 (f conj f)^-1: the Fq6 inverse's products on
// threads, the Fermat chain (fq_sq, a 4-bit window) on one. The hard chain
// squares cyclotomically (Granger-Scott, 27 Fq products) after the easy
// part puts every lane's element in the cyclotomic subgroup; a lane whose
// f is 0 stays 0 under both squarings; the chain reads the bits in sliding
// windows as bls_hard_pow.cu does. A 2-pair lane runs 63 x 63 + 136 x 54
// Fq products in the scan, 393 in the easy part and 485 in its Fermat
// chain, and 1,265 x 27 + 227 x 108 in the hard chain: 70,862.
// Tensor cores stay out: these are 381-bit integer products with carries
// from word to word, and no operand is shared between lanes or products.
#include <cuda_runtime.h>

#include "fq381.cuh"

__global__ void __launch_bounds__(BLS_THREADS)
bls_miller_finalexp_kernel(const int32_t* __restrict__ lines,
                           const int32_t* __restrict__ bits, int nbits,
                           int32_t* __restrict__ out,
                           uint8_t* __restrict__ ok, int b) {
  __shared__ bls_smem s;
  bls_miller_lane(&s, lines, bits, nbits, out, ok, blockIdx.x, b);
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
