// The hard part of the BLS12-381 final exponentiation, m^e per lane, with
// its verdict m^e == 1.
//
// Replaces the JAX package's jitted program `_compiled`
// (cometbft_tpu/ops/bls12.py:230; body :232-234,
// `_is_one_mont(pow_bits(m, HARD_BITS))`), behind `pow_is_one_batch` and
// `final_exp_is_one_batch`. In and out keep its layout: (6, 2, 24, B) int32,
// 16-bit Montgomery limbs (R = 2^384), lanes minor. The exponent's bits come
// as a device tensor, MSB first, bits[0] = 1 (HARD_BITS: 1,268 bits, 633
// ones), so a short exponent can be held too. Beside the verdict the kernel
// writes m^e in canonical limbs, so it can be held against the plain version
// (ops/bls12.bls_hard_pow_plain) exactly.
//
// The JAX program computes the multiply at every bit and selects (1,267
// squarings and 632 multiplies of Fq12); here the bits (public, the same
// for every lane) are read in sliding windows of up to 5 bits over the
// odd powers m .. m^31: 1,265 squarings and 227 products, the same
// function.
//
// Bound on the H100: operations. A lane reads and writes 2.3 KB; its
// chain, the windowed one, at each operation's least (chip_smoke.py
// `_bls_mads`: a multiply 108 Fq products, a general squaring 57, an Fq
// product 576 int32 multiply-adds) is 96,621 Fq products.
//
// Design (fq381.cuh, block code): one lane on one block of 128 threads,
// so at B <= 64 the time is one lane's latency. Each Fq12 operation is a
// product phase, one Fq product a thread (PTX carry-chain Montgomery, two
// accumulators), and a fold phase, 12 threads that sum their slots lazily
// and reduce once. A squaring is its own operation: the 15 cross pairs and
// the 6 diagonal ones, 63 Fq products (a multiply 108); the input is any
// Fq12 element, so no cyclotomic squaring. A lane runs 1,265 x 63 + 227 x
// 108 = 104,211 Fq products.
// Tensor cores stay out: these are 381-bit integer products with carries
// from word to word, and no operand is shared between lanes or products.
#include <cuda_runtime.h>

#include "fq381.cuh"

__global__ void __launch_bounds__(BLS_THREADS)
bls_hard_pow_kernel(const int32_t* __restrict__ arr,
                    const int32_t* __restrict__ bits, int nbits,
                    int32_t* __restrict__ out, uint8_t* __restrict__ ok,
                    int b) {
  __shared__ bls_smem s;
  bls_hard_pow_lane(&s, arr, bits, nbits, out, ok, blockIdx.x, b);
}

extern "C" int cbt_bls_hard_pow(const int32_t* arr, const int32_t* bits,
                                int nbits, int32_t* out, uint8_t* ok, int b,
                                void* stream) {
  if (b > 0)
    bls_hard_pow_kernel<<<b, BLS_THREADS, 0, (cudaStream_t)stream>>>(
        arr, bits, nbits, out, ok, b);
  return (int)cudaGetLastError();
}
