// BLS12-381 arithmetic for the port's two BLS kernels (bls_hard_pow.cu,
// bls_miller_finalexp.cu): the base field Fq, the tower Fq2 = Fq[u]/(u^2+1),
// Fq6 = Fq2[v]/(v^3 - xi) and the flat Fq12 = Fq2[w]/(w^6 - xi), xi = 1 + u,
// as crypto/bls12381.py and the JAX package's ops/bls12.py build them.
//
// An Fq element is 12 little-endian 32-bit words in Montgomery form with
// R = 2^384, the radix of the JAX package's 24 limbs of 16 bits, so the
// two forms hold the same integer and only the words are regrouped at the
// boundary (fq_load16, fq_store16). Every result is canonical (< p):
//   - fq_mul is word-serial Montgomery (CIOS) with 64-bit accumulators:
//     c + a_j*b_i + t_j <= (2^32-1)^2 + 2(2^32-1) = 2^64 - 1. Since
//     4p < 2^384 the running value stays below 2p, so the top word of
//     the accumulator never carries and one conditional subtraction of p
//     ends it;
//   - fq_add subtracts p when a + b >= p (a + b < 2p < 2^382);
//   - fq_sub adds p when a - b borrows.
// Canonical results make the kernels' output equal limb for limb to the
// plain torch versions in ops/bls12.py, whatever order either takes.
//
// The functions above the block section are host-callable, so a host
// compiler can hold them against Python integers
// (tests/test_torch_fq381_host.py). The block section spreads one Fq12
// product over the threads of a block (one lane a block): thread t < 36
// forms the Fq2 product x_i * y_j of pair t (Karatsuba, 3 fq_mul), and
// after a barrier 12 threads, one a coefficient component, sum the pairs
// of degree k and xi times those of degree k + 6 into coefficient k. A
// sparse line c0 + c3 w^3 + c5 w^5 takes the same path with 18 pairs.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define CBT_FN __host__ __device__ __forceinline__
#define CBT_CALL __host__ __device__ __noinline__
#else
#define CBT_FN static inline
#define CBT_CALL static
#endif

#define FQ_WORDS 12
#define FQ_N0 0xfffcfffdu   // -p^-1 mod 2^32
#define FQ_BITS 381         // bit length of p (and of p - 2)

struct fq {
  uint32_t w[FQ_WORDS];
};

struct fq2 {
  fq c0, c1;
};

CBT_FN uint32_t fq_p_word(int i) {
  const uint32_t p[FQ_WORDS] = {
      0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
      0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
      0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return p[i];
}

// word i of p - 2, the Fermat inversion exponent
CBT_FN uint32_t fq_pm2_word(int i) {
  return i == 0 ? 0xffffaaa9u : fq_p_word(i);
}

CBT_FN fq fq_zero() {
  fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) r.w[k] = 0;
  return r;
}

// R mod p: ONE in Montgomery form
CBT_FN fq fq_one() {
  fq r = {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
           0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
           0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}};
  return r;
}

// gamma2_i = xi^(i (p^2 - 1) / 6), which lies in Fq, in Montgomery form:
// the p^2-Frobenius scales Fq12 coefficient i by it
CBT_FN fq fq_gamma2(int i) {
  const uint32_t g[6][FQ_WORDS] = {
      {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
       0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
       0xfa80e493u, 0x15f65ec3u},
      {0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu,
       0x0ec08ff1u, 0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u,
       0xe51c5f59u, 0x0110f184u},
      {0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u,
       0x16a8ca3au, 0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u,
       0x241b6160u, 0x051ba4abu},
      {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u,
       0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu,
       0x3eff0206u, 0x040ab326u},
      {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u,
       0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu,
       0x54638741u, 0x18f02065u},
      {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu,
       0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu,
       0x1564853au, 0x14e56d3fu}};
  fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) r.w[k] = g[i][k];
  return r;
}

// t < 2p -> t mod p
CBT_FN fq fq_cond_sub_p(const fq& t) {
  fq d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    uint64_t v = (uint64_t)t.w[k] - fq_p_word(k) - borrow;
    d.w[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  return borrow ? t : d;
}

CBT_FN fq fq_add(const fq& a, const fq& b) {
  fq s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    c += (uint64_t)a.w[k] + b.w[k];
    s.w[k] = (uint32_t)c;
    c >>= 32;
  }
  return fq_cond_sub_p(s);
}

CBT_FN fq fq_sub(const fq& a, const fq& b) {
  fq d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    uint64_t v = (uint64_t)a.w[k] - b.w[k] - borrow;
    d.w[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) {
      c += (uint64_t)d.w[k] + fq_p_word(k);
      d.w[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

CBT_FN fq fq_neg(const fq& a) { return fq_sub(fq_zero(), a); }

// Montgomery product a * b * 2^-384 mod p (CIOS)
CBT_FN fq fq_mul(const fq& a, const fq& b) {
  uint32_t t[FQ_WORDS + 2];
#pragma unroll
  for (int k = 0; k < FQ_WORDS + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FQ_WORDS; j++) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[FQ_WORDS];
    t[FQ_WORDS] = (uint32_t)c;
    t[FQ_WORDS + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * FQ_N0;
    c = ((uint64_t)m * fq_p_word(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < FQ_WORDS; j++) {
      c += (uint64_t)m * fq_p_word(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[FQ_WORDS];
    t[FQ_WORDS - 1] = (uint32_t)c;
    t[FQ_WORDS] = t[FQ_WORDS + 1] + (uint32_t)(c >> 32);
  }
  fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) r.w[k] = t[k];
  return fq_cond_sub_p(r);
}

CBT_FN bool fq_eq(const fq& a, const fq& b) {
  uint32_t d = 0;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) d |= a.w[k] ^ b.w[k];
  return d == 0;
}

// The serial code below (the easy part's inversion, one thread) calls
// products out of line: inlining each of its ~170 products made the
// Miller kernel's build take minutes.
CBT_CALL fq fq_mul_call(const fq& a, const fq& b) { return fq_mul(a, b); }

// a^(p-2): the inverse, and 0 for 0 (Fermat, as the JAX package's fq_inv)
CBT_CALL fq fq_inv(const fq& a) {
  fq acc = a;  // bit FQ_BITS - 1 of p - 2 is set
  for (int i = FQ_BITS - 2; i >= 0; i--) {
    acc = fq_mul_call(acc, acc);
    if ((fq_pm2_word(i >> 5) >> (i & 31)) & 1u) acc = fq_mul_call(acc, a);
  }
  return acc;
}

// limb k of the JAX layout (16 bits in int32) at base[k * stride]
CBT_FN fq fq_load16(const int32_t* base, long stride) {
  fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++)
    r.w[k] = ((uint32_t)base[(2 * k) * stride] & 0xffffu) |
             ((uint32_t)base[(2 * k + 1) * stride] << 16);
  return r;
}

CBT_FN void fq_store16(int32_t* base, long stride, const fq& a) {
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    base[(2 * k) * stride] = (int32_t)(a.w[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(a.w[k] >> 16);
  }
}

// --- Fq2 -----------------------------------------------------------------------

CBT_FN fq2 fq2_zero() {
  fq2 r = {fq_zero(), fq_zero()};
  return r;
}

CBT_FN fq2 fq2_add(const fq2& a, const fq2& b) {
  fq2 r = {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
  return r;
}

CBT_FN fq2 fq2_sub(const fq2& a, const fq2& b) {
  fq2 r = {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
  return r;
}

CBT_FN fq2 fq2_neg(const fq2& a) {
  fq2 r = {fq_neg(a.c0), fq_neg(a.c1)};
  return r;
}

// times xi = 1 + u
CBT_FN fq2 fq2_mul_xi(const fq2& a) {
  fq2 r = {fq_sub(a.c0, a.c1), fq_add(a.c0, a.c1)};
  return r;
}

// Karatsuba: 3 products
CBT_FN fq2 fq2_mul(const fq2& a, const fq2& b) {
  const fq v0 = fq_mul(a.c0, b.c0);
  const fq v1 = fq_mul(a.c1, b.c1);
  const fq s = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
  fq2 r = {fq_sub(v0, v1), fq_sub(fq_sub(s, v0), v1)};
  return r;
}

CBT_CALL fq2 fq2_mul_call(const fq2& a, const fq2& b) {
  return fq2_mul(a, b);
}

CBT_CALL fq2 fq2_inv(const fq2& a) {
  const fq ni = fq_inv(fq_add(fq_mul_call(a.c0, a.c0),
                              fq_mul_call(a.c1, a.c1)));
  fq2 r = {fq_mul_call(a.c0, ni), fq_neg(fq_mul_call(a.c1, ni))};
  return r;
}

CBT_FN bool fq2_is(const fq2& a, const fq& c0) {
  return fq_eq(a.c0, c0) && fq_eq(a.c1, fq_zero());
}

// --- Fq6 and the Fq12 inversion (serial, one thread) --------------------------

struct fq6 {
  fq2 c[3];
};

CBT_CALL fq6 fq6_mul(const fq6& a, const fq6& b) {
  fq2 t[5];
  for (int k = 0; k < 5; k++) t[k] = fq2_zero();
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) t[i + j] = fq2_add(t[i + j], fq2_mul_call(a.c[i], b.c[j]));
  fq6 r;
  r.c[0] = fq2_add(t[0], fq2_mul_xi(t[3]));
  r.c[1] = fq2_add(t[1], fq2_mul_xi(t[4]));
  r.c[2] = t[2];
  return r;
}

CBT_CALL fq6 fq6_inv(const fq6& a) {
  const fq2 big_a = fq2_sub(fq2_mul_call(a.c[0], a.c[0]),
                            fq2_mul_xi(fq2_mul_call(a.c[1], a.c[2])));
  const fq2 big_b = fq2_sub(fq2_mul_xi(fq2_mul_call(a.c[2], a.c[2])),
                            fq2_mul_call(a.c[0], a.c[1]));
  const fq2 big_c = fq2_sub(fq2_mul_call(a.c[1], a.c[1]), fq2_mul_call(a.c[0], a.c[2]));
  const fq2 f = fq2_add(fq2_mul_call(a.c[0], big_a),
                        fq2_mul_xi(fq2_add(fq2_mul_call(a.c[1], big_c),
                                           fq2_mul_call(a.c[2], big_b))));
  const fq2 fi = fq2_inv(f);
  fq6 r;
  r.c[0] = fq2_mul_call(big_a, fi);
  r.c[1] = fq2_mul_call(big_b, fi);
  r.c[2] = fq2_mul_call(big_c, fi);
  return r;
}

// out = a^-1 over the flat w-basis: with A = (a0, a2, a4) and
// B = (a1, a3, a5), a^-1 = (A - B w) / (A^2 - v B^2), as
// crypto/bls12381.f12_inv; a = 0 gives 0 (as the JAX package's f12_inv)
CBT_CALL void f12_inv_serial(const fq2* a, fq2* out) {
  fq6 big_a, big_b;
  for (int k = 0; k < 3; k++) {
    big_a.c[k] = a[2 * k];
    big_b.c[k] = a[2 * k + 1];
  }
  const fq6 aa = fq6_mul(big_a, big_a);
  const fq6 bb = fq6_mul(big_b, big_b);
  fq6 den;
  den.c[0] = fq2_sub(aa.c[0], fq2_mul_xi(bb.c[2]));   // A^2 - v B^2
  den.c[1] = fq2_sub(aa.c[1], bb.c[0]);
  den.c[2] = fq2_sub(aa.c[2], bb.c[1]);
  const fq6 di = fq6_inv(den);
  fq6 nb;
  for (int k = 0; k < 3; k++) nb.c[k] = fq2_neg(big_b.c[k]);
  const fq6 ia = fq6_mul(big_a, di);
  const fq6 ib = fq6_mul(nb, di);
  for (int k = 0; k < 3; k++) {
    out[2 * k] = ia.c[k];
    out[2 * k + 1] = ib.c[k];
  }
}

// --- the block section: one lane on one block --------------------------------
#if defined(__CUDACC__) || defined(CBT_BLOCK_SHIM)

#define BLS_THREADS 64   // >= 36, the pairs of a full Fq12 product

// degree of coefficient jj of y: y is full (ny = 6) or a sparse line
// c0 + c3 w^3 + c5 w^5 (ny = 3)
__device__ __forceinline__ int bls_deg(int ny, int jj) {
  return ny == 6 ? jj : (jj == 0 ? 0 : (jj == 1 ? 3 : 5));
}

// out = x * y, all in shared memory; prod is shared scratch of 36 Fq2.
// out may alias x or y: every read of x and y comes before the first
// barrier, every write of out after it. Called by all threads. After the
// products, thread t < 12 forms component t % 2 of coefficient k = t / 2
// from the pairs of degree k (x_i y_j with i = k - deg j) and, times xi,
// those of degree k + 6 (i = k + 6 - deg j): at most 6 pairs each.
__device__ __noinline__ void f12_mul_block(fq2* out, const fq2* x,
                                           const fq2* y, int ny, fq2* prod) {
  const int t = threadIdx.x;
  if (t < 6 * ny) prod[t] = fq2_mul(x[t / ny], y[t % ny]);
  __syncthreads();
  if (t < 12) {
    const int k = t >> 1;
    fq lo = fq_zero(), hi0 = fq_zero(), hi1 = fq_zero();
    for (int jj = 0; jj < ny; jj++) {
      const int d = bls_deg(ny, jj);
      const int il = k - d, ih = k + 6 - d;
      if (il >= 0 && il < 6) {
        const fq2& p = prod[il * ny + jj];
        lo = fq_add(lo, (t & 1) ? p.c1 : p.c0);
      }
      if (ih >= 0 && ih < 6) {
        const fq2& p = prod[ih * ny + jj];
        hi0 = fq_add(hi0, p.c0);
        hi1 = fq_add(hi1, p.c1);
      }
    }
    // xi * hi = (hi0 - hi1) + (hi0 + hi1) u
    const fq v = fq_add(lo, (t & 1) ? fq_add(hi0, hi1) : fq_sub(hi0, hi1));
    if (t & 1) out[k].c1 = v;
    else out[k].c0 = v;
  }
  __syncthreads();
}

// acc = m^e for MSB-first bits (bits[0] = 1 seeds acc = m, which the
// caller has stored). A zero bit skips its multiply: the bits are the
// same for every lane, so no block diverges.
__device__ void f12_pow_block(fq2* acc, const fq2* m,
                              const int32_t* __restrict__ bits, int nbits,
                              fq2* prod) {
  for (int s = 1; s < nbits; s++) {
    f12_mul_block(acc, acc, acc, 6, prod);
    if (bits[s]) f12_mul_block(acc, acc, m, 6, prod);
  }
}

// Fq12 element (i, c) of lane `lane` in the (6, 2, 24, B) layout
__device__ __forceinline__ long bls_elem(int i, int c, int lane, int b) {
  return (long)(i * 2 + c) * 24 * b + lane;
}

// threads t < 12 load coefficient t/2, component t%2, of lane `lane`
__device__ __forceinline__ void f12_load_block(fq2* dst,
                                               const int32_t* __restrict__ arr,
                                               int lane, int b) {
  const int t = threadIdx.x;
  if (t < 12) {
    const fq v = fq_load16(arr + bls_elem(t >> 1, t & 1, lane, b), b);
    if (t & 1) dst[t >> 1].c1 = v;
    else dst[t >> 1].c0 = v;
  }
}

// threads t < 12 store; thread 0 writes the verdict x == 1
__device__ __forceinline__ void f12_store_block(int32_t* __restrict__ out,
                                                uint8_t* __restrict__ ok,
                                                const fq2* x, int lane, int b) {
  const int t = threadIdx.x;
  if (t < 12)
    fq_store16(out + bls_elem(t >> 1, t & 1, lane, b), b,
               (t & 1) ? x[t >> 1].c1 : x[t >> 1].c0);
  if (t == 0) {
    bool one = fq2_is(x[0], fq_one());
    for (int i = 1; i < 6; i++) one = one && fq2_is(x[i], fq_zero());
    ok[lane] = one ? 1 : 0;
  }
}

#endif  // block section
