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
// Bound on the H100: operations. A lane reads and writes 2.3 KB, and its
// chain is 1,267 squarings and 632 multiplies of Fq12. The bound
// (chip_smoke.py `_bls_mads`) counts each at its least: a multiply as 36
// Fq2 products of 3 Fq products (108), a squaring by its distinct products
// only, 6 Fq2 squarings of 2 Fq products and 15 Fq2 products (57; the
// input is any Fq12 element, so no cyclotomic squaring), an Fq product as
// 2 x 12^2 32-bit multiply-adds for the product and as many for the
// reduction, lo and hi: 576. This kernel squares as it multiplies (108).
// The JAX program computes the multiply at every bit and selects; here a
// zero bit skips it (the bits are public and the same for every lane),
// which is the same function.
//
// Design: one lane on one block of BLS_THREADS = 64 threads (fq381.cuh,
// block section). Thread t < 36 forms one Fq2 product of the 36 an Fq12
// product needs (3 Fq products, Karatsuba), and after a barrier twelve
// threads, one a coefficient component, fold them by degree (and by xi
// for degrees 6 to 10) through shared memory, each reading only its own
// pairs (at most 6 of each degree). A lane's latency is then ~1,900 chains of 3 dependent
// Fq products and a fold, against ~2.0e5 dependent Fq products on one
// thread. At B <= 64 lanes the card holds every block at once, so the
// time is one lane's latency at any bucket, not the bound. More lanes a
// block, a dedicated squaring and cyclotomic squaring are left for later.
// ptxas (sm_90a, -O3): 106 registers, no spills, 4,608 bytes of shared
// memory. On one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) a call
// takes 13.5, 14.0 and 15.0 ms of device time at B = 4, 16 and 64, about
// 7.4 us an Fq12 product, against bounds of 0.019, 0.077 and 0.310 ms.
// A first fold on six threads, each scanning all 36 pairs, took twice
// as long (27.6-28.8 ms in another call).
#include <cuda_runtime.h>

#include "fq381.cuh"

__global__ void __launch_bounds__(BLS_THREADS)
bls_hard_pow_kernel(const int32_t* __restrict__ arr,
                    const int32_t* __restrict__ bits, int nbits,
                    int32_t* __restrict__ out, uint8_t* __restrict__ ok,
                    int b) {
  __shared__ fq2 m[6], acc[6], prod[36];
  const int lane = blockIdx.x;
  f12_load_block(m, arr, lane, b);
  f12_load_block(acc, arr, lane, b);
  __syncthreads();
  f12_pow_block(acc, m, bits, nbits, prod);
  f12_store_block(out, ok, acc, lane, b);
}

extern "C" int cbt_bls_hard_pow(const int32_t* arr, const int32_t* bits,
                                int nbits, int32_t* out, uint8_t* ok, int b,
                                void* stream) {
  if (b > 0)
    bls_hard_pow_kernel<<<b, BLS_THREADS, 0, (cudaStream_t)stream>>>(
        arr, bits, nbits, out, ok, b);
  return (int)cudaGetLastError();
}
