// BLS12-381 arithmetic for the port's two BLS kernels (bls_hard_pow.cu,
// bls_miller_finalexp.cu): the base field Fq, Fq2 = Fq[u]/(u^2+1) and the
// flat Fq12 = Fq2[w]/(w^6 - xi), xi = 1 + u, as crypto/bls12381.py and the
// JAX package's ops/bls12.py build them, and the block code that runs one
// lane of each kernel on one block.
//
// An Fq element is 12 little-endian 32-bit words in Montgomery form with
// R = 2^384, the radix of the JAX package's 24 limbs of 16 bits, so the two
// forms hold the same integer and only the words are regrouped at the
// boundary (fq_load16, fq_store16).
//
// Field code. Every carry runs through the PTX carry flag: each cbt_* primitive
// below is one PTX instruction (add.cc, addc, sub.cc, subc, mad.lo.cc,
// madc.hi.cc, ...) and the flag flows from one to the next in program order.
// Under a host compiler (no __CUDA_ARCH__) each primitive is a C++ twin over
// a thread-local flag, so the same routines run on the host and are held
// against Python integers there (tests/test_torch_fq381_host.py); the card
// compiles the PTX, and chip_smoke.py holds the kernels there.
//   - fq_mul is a Montgomery product (CIOS) over two accumulators: E at word
//     offset 0 takes the products of the even words of a, O at offset 1 those
//     of the odd words, so each row is two independent carry chains. After a
//     row's reduction E[0] = 0; the division by 2^32 renames the arrays:
//     the next E is O with E[1] added at word 0, whose carry flows into the
//     next O-chain, which also shifts E[2..11] down two words. A carry out of
//     an E-chain lands on O[11] (the same weight, 2^384); O itself never
//     overflows (2^32 O <= the running value < 2^415). Inputs may be lazy,
//     below 2p: the result (ab + Mp)/2^384 < 4p^2/2^384 + p < 1.5p, and one
//     conditional subtraction makes it canonical.
//   - fq_sq squares with the 78 distinct word products: the 66 off-diagonal
//     products row by row into two arrays (each row's products of odd and
//     even distance are two chains), doubled, plus the 12 diagonal squares;
//     then the Montgomery reduction of the low half in the same two-array
//     form, plus the high half. Canonical inputs only.
//   - fq_add, fq_sub return canonical values for canonical inputs; the lazy
//     sums that feed products (below 2p) are fq_lazy_add.
//   - fq_inv is a^(p-2) with a 4-bit window (380 squarings, 91 products and
//     14 for the table); 0 gives 0.
// Canonical results make the kernels' output equal limb for limb to the
// plain torch versions in ops/bls12.py, whatever order either takes.
//
// Block code (below the field code): one lane on one block of BLS_THREADS
// threads, every Fq12 operation as two phases with a barrier after each.
//   - Products: thread t < 3G forms Fq product r = t % 3 of Fq2 product
//     g = t / 3 (Karatsuba: a0 b0, a1 b1, (a0 + a1)(b0 + b1)), one product a
//     thread: 36 groups (108 threads) for a full Fq12 product, 21 for a
//     squaring, 18 for a sparse line, 9 for a cyclotomic squaring. A group's
//     first factor may be taken times xi, -1, -xi or conjugated: its terms
//     are lazy sums of a0, a1, p - a0, p - a1 (below 2p), so a pair whose
//     degrees reach 6 or more folds its xi into the product itself.
//   - Fold: thread o < 12 (one coefficient component) sums the Karatsuba
//     terms of its slots lazily in 12 words (S0 = sum a0 b0, S1 = sum a1 b1,
//     Ss = sum of the third products; at most 6 slots, below 6p), forms
//     S0 - S1 or Ss - S0 - S1 plus 12p in 13 words, and reduces once
//     (quotient from the top words, one product by it, one conditional
//     subtraction).
// The hard chain reads its bits left to right in sliding windows of up to
// 5 bits over the odd powers m .. m^31 (bls_pow): 227 products for the
// final exponentiation's 632 ones. A squaring lists each cross pair twice
// and each diagonal once; the
// cyclotomic squaring (Granger-Scott, after the easy part) forms the three
// Fq4 squares (x^2 + xi y^2, 2xy) of the pairs (a0, a3), (a1, a4), (a2, a5)
// and folds 3 T +- 2 a into each coefficient. The easy part's inversion runs
// its Fq6/Fq2 products on threads (f conj f, the Fq6 cofactors, the norm)
// and only the Fermat chain on one thread.
//
// Every phase is written as a function of the thread index t, and
// BLS_STEP runs it: on the card for t = threadIdx.x followed by a barrier,
// on the host for every t in turn. So the block code, kernels' lanes
// included, runs unchanged under a host compiler.
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

struct alignas(16) fq {   // 16-byte aligned: shared-memory copies are 128-bit
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

// word i of 2^384 - p: adding q times it subtracts q p mod 2^384
CBT_FN uint32_t fq_np_word(int i) {
  const uint32_t np[FQ_WORDS] = {
      0x00005555u, 0x46010000u, 0x4eac0000u, 0xe1540001u,
      0x094f09dbu, 0x98cf2d5fu, 0x0c7aed40u, 0x9b88b47bu,
      0xbcb45328u, 0xb4e45849u, 0xc6801965u, 0xe5feee15u};
  return np[i];
}

// word i of 12 p (13 words): the fold's bias
CBT_FN uint32_t fq_p12_word(int i) {
  const uint32_t k[FQ_WORDS + 1] = {
      0xfffc0004u, 0xb7f3ffffu, 0x4feffffcu, 0x700ffff0u, 0x904b89b1u,
      0xd649df8bu, 0x6a3ce0f8u, 0xb5978a3bu, 0x278c1a18u, 0x854bdc8bu,
      0xb1fecf3bu, 0x380cd6fau, 0x00000001u};
  return k[i];
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

// --- carry-chain primitives: one PTX instruction each ----------------------
#if defined(__CUDA_ARCH__)
#define CBT_PTX3(name, op)                                                 \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {       \
    uint32_t d;                                                            \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));            \
    return d;                                                              \
  }
#define CBT_PTX4(name, op)                                                 \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,         \
                                           uint32_t c) {                   \
    uint32_t d;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c)); \
    return d;                                                              \
  }
CBT_PTX3(cbt_add_cc, "add.cc.u32")
CBT_PTX3(cbt_addc_cc, "addc.cc.u32")
CBT_PTX3(cbt_addc, "addc.u32")
CBT_PTX3(cbt_sub_cc, "sub.cc.u32")
CBT_PTX3(cbt_subc_cc, "subc.cc.u32")
CBT_PTX3(cbt_subc, "subc.u32")
CBT_PTX4(cbt_mad_lo_cc, "mad.lo.cc.u32")
CBT_PTX4(cbt_mad_hi_cc, "mad.hi.cc.u32")
CBT_PTX4(cbt_madc_lo_cc, "madc.lo.cc.u32")
CBT_PTX4(cbt_madc_hi_cc, "madc.hi.cc.u32")
CBT_PTX4(cbt_madc_lo, "madc.lo.u32")
CBT_PTX4(cbt_madc_hi, "madc.hi.u32")
#undef CBT_PTX3
#undef CBT_PTX4
__device__ __forceinline__ uint32_t cbt_mulhi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
#else
// the host twins: the carry (or, for sub and subc, the borrow) flag
static thread_local uint32_t cbt_cf;
static inline uint32_t cbt_set(uint64_t s) {
  cbt_cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
static inline uint32_t cbt_add_cc(uint32_t a, uint32_t b) {
  return cbt_set((uint64_t)a + b);
}
static inline uint32_t cbt_addc_cc(uint32_t a, uint32_t b) {
  return cbt_set((uint64_t)a + b + cbt_cf);
}
static inline uint32_t cbt_addc(uint32_t a, uint32_t b) { return a + b + cbt_cf; }
static inline uint32_t cbt_sub_cc(uint32_t a, uint32_t b) {
  cbt_cf = a < b;
  return a - b;
}
static inline uint32_t cbt_subc_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)b + cbt_cf;
  cbt_cf = (uint64_t)a < s;
  return (uint32_t)((uint64_t)a - s);
}
static inline uint32_t cbt_subc(uint32_t a, uint32_t b) { return a - b - cbt_cf; }
static inline uint32_t cbt_mulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
static inline uint32_t cbt_mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cbt_set((uint64_t)(a * b) + c);
}
static inline uint32_t cbt_mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cbt_set((uint64_t)cbt_mulhi(a, b) + c);
}
static inline uint32_t cbt_madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cbt_set((uint64_t)(a * b) + c + cbt_cf);
}
static inline uint32_t cbt_madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cbt_set((uint64_t)cbt_mulhi(a, b) + c + cbt_cf);
}
static inline uint32_t cbt_madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  return a * b + c + cbt_cf;
}
static inline uint32_t cbt_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return cbt_mulhi(a, b) + c + cbt_cf;
}
#endif

// --- Fq ----------------------------------------------------------------------

// t < 2p (as 12 words) -> t mod p
CBT_FN fq fq_cond_sub_p(const fq& t) {
  fq d;
  d.w[0] = cbt_sub_cc(t.w[0], fq_p_word(0));
#pragma unroll
  for (int k = 1; k < FQ_WORDS; k++) d.w[k] = cbt_subc_cc(t.w[k], fq_p_word(k));
  const uint32_t keep = cbt_subc(0, 0);   // all ones if t < p
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++)
    d.w[k] = (t.w[k] & keep) | (d.w[k] & ~keep);
  return d;
}

// a + b without reduction (the caller keeps it below 2^384)
CBT_FN fq fq_lazy_add(const fq& a, const fq& b) {
  fq s;
  s.w[0] = cbt_add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++) s.w[k] = cbt_addc_cc(a.w[k], b.w[k]);
  s.w[FQ_WORDS - 1] = cbt_addc(a.w[FQ_WORDS - 1], b.w[FQ_WORDS - 1]);
  return s;
}

// p - a for 0 <= a <= p
CBT_FN fq fq_p_minus(const fq& a) {
  fq d;
  d.w[0] = cbt_sub_cc(fq_p_word(0), a.w[0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++) d.w[k] = cbt_subc_cc(fq_p_word(k), a.w[k]);
  d.w[FQ_WORDS - 1] = cbt_subc(fq_p_word(FQ_WORDS - 1), a.w[FQ_WORDS - 1]);
  return d;
}

CBT_FN fq fq_add(const fq& a, const fq& b) {
  return fq_cond_sub_p(fq_lazy_add(a, b));
}

CBT_FN fq fq_sub(const fq& a, const fq& b) {
  fq d;
  d.w[0] = cbt_sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS; k++) d.w[k] = cbt_subc_cc(a.w[k], b.w[k]);
  const uint32_t m = cbt_subc(0, 0);      // all ones on a borrow: add p
  d.w[0] = cbt_add_cc(d.w[0], fq_p_word(0) & m);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++)
    d.w[k] = cbt_addc_cc(d.w[k], fq_p_word(k) & m);
  d.w[FQ_WORDS - 1] = cbt_addc(d.w[FQ_WORDS - 1], fq_p_word(FQ_WORDS - 1) & m);
  return d;
}

// one reduction row: m = E[0] (-p^-1); E += even words of m p, O += odd
// words (O at word offset 1); E[0] becomes 0. The O-chain cannot carry
// out; the E-chain's carry lands on O[11].
CBT_FN void fq_redc_row(uint32_t* E, uint32_t* O) {
  const uint32_t m = E[0] * FQ_N0;
  O[0] = cbt_mad_lo_cc(fq_p_word(1), m, O[0]);
  O[1] = cbt_madc_hi_cc(fq_p_word(1), m, O[1]);
#pragma unroll
  for (int k = 1; k < 5; k++) {
    O[2 * k] = cbt_madc_lo_cc(fq_p_word(2 * k + 1), m, O[2 * k]);
    O[2 * k + 1] = cbt_madc_hi_cc(fq_p_word(2 * k + 1), m, O[2 * k + 1]);
  }
  O[10] = cbt_madc_lo_cc(fq_p_word(11), m, O[10]);
  O[11] = cbt_madc_hi(fq_p_word(11), m, O[11]);
  E[0] = cbt_mad_lo_cc(fq_p_word(0), m, E[0]);
  E[1] = cbt_madc_hi_cc(fq_p_word(0), m, E[1]);
#pragma unroll
  for (int k = 1; k < 6; k++) {
    E[2 * k] = cbt_madc_lo_cc(fq_p_word(2 * k), m, E[2 * k]);
    E[2 * k + 1] = cbt_madc_hi_cc(fq_p_word(2 * k), m, E[2 * k + 1]);
  }
  O[11] = cbt_addc(O[11], 0);
}

// (E, O) with E[0] = 0 -> (E + 2^32 O) / 2^32, canonical when it is < 2p
CBT_FN fq fq_redc_merge(const uint32_t* E, const uint32_t* O) {
  fq r;
  r.w[0] = cbt_add_cc(O[0], E[1]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++) r.w[k] = cbt_addc_cc(O[k], E[k + 1]);
  r.w[FQ_WORDS - 1] = cbt_addc(O[FQ_WORDS - 1], 0);
  return r;
}

// Montgomery product a b 2^-384 mod p, canonical, for a, b < 2p
CBT_FN fq fq_mul(const fq& a, const fq& b) {
  uint32_t E[FQ_WORDS], O[FQ_WORDS];
  const uint32_t b0 = b.w[0];
#pragma unroll
  for (int k = 0; k < 6; k++) {
    E[2 * k] = a.w[2 * k] * b0;
    E[2 * k + 1] = cbt_mulhi(a.w[2 * k], b0);
    O[2 * k] = a.w[2 * k + 1] * b0;
    O[2 * k + 1] = cbt_mulhi(a.w[2 * k + 1], b0);
  }
  fq_redc_row(E, O);
#pragma unroll
  for (int i = 1; i < FQ_WORDS; i++) {
    const uint32_t bi = b.w[i];
    uint32_t E2[FQ_WORDS], O2[FQ_WORDS];
    // divide by 2^32: E2 = O + E[1]; O2 = E[2..11] + the carry + odd words
    E2[0] = cbt_add_cc(O[0], E[1]);
#pragma unroll
    for (int k = 0; k < 5; k++) {
      O2[2 * k] = cbt_madc_lo_cc(a.w[2 * k + 1], bi, E[2 * k + 2]);
      O2[2 * k + 1] = cbt_madc_hi_cc(a.w[2 * k + 1], bi, E[2 * k + 3]);
    }
    O2[10] = cbt_madc_lo_cc(a.w[11], bi, 0);
    O2[11] = cbt_madc_hi(a.w[11], bi, 0);
#pragma unroll
    for (int k = 1; k < FQ_WORDS; k++) E2[k] = O[k];
    E2[0] = cbt_mad_lo_cc(a.w[0], bi, E2[0]);
    E2[1] = cbt_madc_hi_cc(a.w[0], bi, E2[1]);
#pragma unroll
    for (int k = 1; k < 6; k++) {
      E2[2 * k] = cbt_madc_lo_cc(a.w[2 * k], bi, E2[2 * k]);
      E2[2 * k + 1] = cbt_madc_hi_cc(a.w[2 * k], bi, E2[2 * k + 1]);
    }
    O2[11] = cbt_addc(O2[11], 0);
    fq_redc_row(E2, O2);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) {
      E[k] = E2[k];
      O[k] = O2[k];
    }
  }
  return fq_cond_sub_p(fq_redc_merge(E, O));
}

// a^2 2^-384 mod p, canonical, for a < p: 78 word products
CBT_FN fq fq_sq(const fq& a) {
  // off-diagonal a_i a_j (i < j) at word i + j: row i's products of odd
  // distance j - i form one chain into X (from word 2i + 1), those of even
  // distance one into Y (from word 2i + 2). A row's chain ends at word
  // i + 11 or i + 12 and carries into a word that is fresh or holds an
  // earlier row's carry (at most 1), so it cannot carry further.
  uint32_t X[24], Y[24];
#pragma unroll
  for (int k = 0; k < 24; k++) X[k] = Y[k] = 0;
#pragma unroll
  for (int i = 0; i < 11; i++) {
#pragma unroll
    for (int par = 1; par <= 2; par++) {
      uint32_t* acc = par == 1 ? X : Y;
      if (i + par > 11) continue;
      int top = 0;
#pragma unroll
      for (int j = i + par; j < FQ_WORDS; j += 2) {
        const int w = i + j;
        acc[w] = j == i + par ? cbt_mad_lo_cc(a.w[i], a.w[j], acc[w])
                              : cbt_madc_lo_cc(a.w[i], a.w[j], acc[w]);
        acc[w + 1] = cbt_madc_hi_cc(a.w[i], a.w[j], acc[w + 1]);
        top = w + 1;
      }
      acc[top + 1] = cbt_addc(acc[top + 1], 0);
    }
  }
  // T = 2 (X + Y) + the diagonal squares
  uint32_t S[24], T[24];
  S[0] = 0;
  S[1] = cbt_add_cc(X[1], Y[1]);
#pragma unroll
  for (int k = 2; k < 23; k++) S[k] = cbt_addc_cc(X[k], Y[k]);
  S[23] = cbt_addc(X[23], Y[23]);
  T[0] = 0;
#pragma unroll
  for (int k = 1; k < 24; k++) T[k] = (S[k] << 1) | (S[k - 1] >> 31);
  T[0] = cbt_mad_lo_cc(a.w[0], a.w[0], T[0]);
  T[1] = cbt_madc_hi_cc(a.w[0], a.w[0], T[1]);
#pragma unroll
  for (int i = 1; i < FQ_WORDS - 1; i++) {
    T[2 * i] = cbt_madc_lo_cc(a.w[i], a.w[i], T[2 * i]);
    T[2 * i + 1] = cbt_madc_hi_cc(a.w[i], a.w[i], T[2 * i + 1]);
  }
  T[22] = cbt_madc_lo_cc(a.w[11], a.w[11], T[22]);
  T[23] = cbt_madc_hi(a.w[11], a.w[11], T[23]);
  // REDC of the low half (E = T_lo, O = 0), then + the high half
  uint32_t E[FQ_WORDS], O[FQ_WORDS];
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    E[k] = T[k];
    O[k] = 0;
  }
  fq_redc_row(E, O);
#pragma unroll
  for (int i = 1; i < FQ_WORDS; i++) {
    uint32_t E2[FQ_WORDS], O2[FQ_WORDS];
    E2[0] = cbt_add_cc(O[0], E[1]);
    const uint32_t m = E2[0] * FQ_N0;     // no carry flag between
#pragma unroll
    for (int k = 0; k < 5; k++) {
      O2[2 * k] = cbt_madc_lo_cc(fq_p_word(2 * k + 1), m, E[2 * k + 2]);
      O2[2 * k + 1] = cbt_madc_hi_cc(fq_p_word(2 * k + 1), m, E[2 * k + 3]);
    }
    O2[10] = cbt_madc_lo_cc(fq_p_word(11), m, 0);
    O2[11] = cbt_madc_hi(fq_p_word(11), m, 0);
#pragma unroll
    for (int k = 1; k < FQ_WORDS; k++) E2[k] = O[k];
    E2[0] = cbt_mad_lo_cc(fq_p_word(0), m, E2[0]);
    E2[1] = cbt_madc_hi_cc(fq_p_word(0), m, E2[1]);
#pragma unroll
    for (int k = 1; k < 6; k++) {
      E2[2 * k] = cbt_madc_lo_cc(fq_p_word(2 * k), m, E2[2 * k]);
      E2[2 * k + 1] = cbt_madc_hi_cc(fq_p_word(2 * k), m, E2[2 * k + 1]);
    }
    O2[11] = cbt_addc(O2[11], 0);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) {
      E[k] = E2[k];
      O[k] = O2[k];
    }
  }
  const fq lo = fq_redc_merge(E, O);    // (T_lo + M p) / 2^384 <= p
  fq hi;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) hi.w[k] = T[FQ_WORDS + k];
  return fq_cond_sub_p(fq_lazy_add(lo, hi));   // < p + p/8
}

CBT_FN bool fq_eq(const fq& a, const fq& b) {
  uint32_t d = 0;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) d |= a.w[k] ^ b.w[k];
  return d == 0;
}

CBT_CALL fq fq_mul_call(const fq& a, const fq& b) { return fq_mul(a, b); }
CBT_CALL fq fq_sq_call(const fq& a) { return fq_sq(a); }

// a^(p-2): the inverse, and 0 for 0 (Fermat, as the JAX package's fq_inv).
// Bit 380 of p - 2 is its top bit; the 95 nibbles below it each take four
// squarings and, unless 0, one product by a^nibble from the table.
CBT_CALL fq fq_inv(const fq& a) {
  fq tab[16];
  tab[1] = a;
  tab[2] = fq_sq_call(a);
  for (int k = 3; k < 16; k++) tab[k] = fq_mul_call(tab[k - 1], a);
  fq acc = a;
  for (int n = 94; n >= 0; n--) {
    for (int k = 0; k < 4; k++) acc = fq_sq_call(acc);
    const uint32_t nib = (fq_pm2_word(n >> 3) >> ((n & 7) * 4)) & 0xfu;
    if (nib) acc = fq_mul_call(acc, tab[nib]);
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

// v < 2^387 in 13 words (v[12] small) -> v mod p. q = floor(top / (p11 +
// 1)), top = v >> 352, is at most floor(v / p) and at least floor(v / p) - 1,
// so v - q p < 2p: one product by q (adding q (2^384 - p) mod 2^384) and
// one conditional subtraction.
CBT_FN fq fq_reduce13(const uint32_t* v) {
  const uint64_t top = ((uint64_t)v[12] << 32) | v[11];
  const uint64_t div = (uint64_t)fq_p_word(11) + 1;
  uint64_t q = (uint64_t)((double)top * (1.0 / (double)div));
  if (q * div > top) q--;
  if ((q + 1) * div <= top) q++;
  const uint32_t qq = (uint32_t)q;
  fq r;
  r.w[0] = cbt_mad_lo_cc(qq, fq_np_word(0), v[0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++)
    r.w[k] = cbt_madc_lo_cc(qq, fq_np_word(k), v[k]);
  r.w[FQ_WORDS - 1] = cbt_madc_lo(qq, fq_np_word(FQ_WORDS - 1), v[FQ_WORDS - 1]);
  r.w[1] = cbt_mad_hi_cc(qq, fq_np_word(0), r.w[1]);
#pragma unroll
  for (int k = 2; k < FQ_WORDS - 1; k++)
    r.w[k] = cbt_madc_hi_cc(qq, fq_np_word(k - 1), r.w[k]);
  r.w[FQ_WORDS - 1] =
      cbt_madc_hi(qq, fq_np_word(FQ_WORDS - 2), r.w[FQ_WORDS - 1]);
  return fq_cond_sub_p(r);
}

// --- the block code: one lane on one block -----------------------------------

#define BLS_THREADS 128   // >= 3 x 36, the products of a full Fq12 product
#define BLS_GROUPS 42     // Fq2 products a phase can hold
#define BLS_WIN 5         // the hard chain's sliding window: 16 odd powers

#if defined(__CUDA_ARCH__)
#define BLS_T const int t = threadIdx.x
#define BLS_STEP(...) \
  do {                \
    __VA_ARGS__;      \
    __syncthreads();  \
  } while (0)
#else
#define BLS_T
#define BLS_STEP(...)                        \
  do {                                       \
    for (int t = 0; t < BLS_THREADS; t++) {  \
      __VA_ARGS__;                           \
    }                                        \
  } while (0)
#endif

// the first factor of a group, taken as is, times xi, times -1, times -xi,
// or conjugated
enum { XF_ID = 0, XF_XI = 1, XF_NEG = 2, XF_NXI = 3, XF_CONJ = 4 };

struct bls_pd {            // one Fq2 product of a phase
  const fq2* a;
  int xf;
  const fq2* b;            // or, if b is null, b16: 16-bit limbs [comp][24]
  const int32_t* b16;
};

struct bls_fd {            // one output component of a fold
  fq* dst;
  int comp;                // 0: S0 - S1; 1: Ss - S0 - S1
  int ns;                  // slots (Fq2 products) summed
  int g[6];
  const fq* ex;            // if set, the output is 3 D + 2 ex (ex_neg: - 2 ex)
  int ex_neg;
};

struct bls_smem {
  fq v[3 * BLS_GROUPS];    // the phase's products
  fq2 f[6], m[6], u[6];    // Fq12 values
  fq2 gam[6];              // (gamma2_i, 0), the p^2-Frobenius scalars
  fq2 c6[6];               // the inversion's Fq6/Fq2 pieces
  fq2 pw[1 << (BLS_WIN - 1)][6];  // m, m^3, ..., m^31 for the hard chain
  int32_t line[2][4][3][2][24];   // a Miller step's lines, double buffered
  uint32_t live[2];        // per buffer: bit s set if slot s is not ONE
};

CBT_FN fq fq_pick(int sel, const fq& a0, const fq& a1, const fq& n0,
                  const fq& n1) {
  fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++)
    r.w[k] = sel == 1 ? a0.w[k] : sel == 2 ? a1.w[k]
           : sel == 3 ? n0.w[k] : sel == 4 ? n1.w[k] : 0u;
  return r;
}

// Fq product r of group (a, xf, b): (a'_0 b0, a'_1 b1, (a'_0 + a'_1)(b0 +
// b1)) for a' = a transformed by xf; each factor is a lazy sum of two terms
// from {0, a0, a1, p - a0, p - a1} (or b0, b1), below 2p. b16 stands for b
// as 16-bit limbs [comp][24] when b is null.
CBT_CALL void bls_prod_core(int r, const fq2* a, int xf, const fq2* b,
                            const int32_t* b16, fq* out) {
  // per transform, the 3-bit selectors (1 a0, 2 a1, 3 p - a0, 4 p - a1) of
  // the two terms of products 0, 1, 2: ID, XI, NEG, NXI, CONJ
  const uint32_t sel = xf == XF_ID ? 0x11081u : xf == XF_XI ? 0x9461u
                     : xf == XF_NEG ? 0x23103u : xf == XF_NXI ? 0x1b8dau : 0x21101u;
  const fq a0 = a->c0, a1 = a->c1;
  const fq n0 = fq_p_minus(a0), n1 = fq_p_minus(a1);
  const fq x = fq_lazy_add(fq_pick((sel >> (6 * r)) & 7, a0, a1, n0, n1),
                           fq_pick((sel >> (6 * r + 3)) & 7, a0, a1, n0, n1));
  fq b0, b1;
  if (b) {
    b0 = b->c0;
    b1 = b->c1;
  } else {
    b0 = fq_load16(b16, 1);
    b1 = fq_load16(b16 + 24, 1);
  }
  const fq y = fq_lazy_add(r == 1 ? b1 : b0, r == 2 ? b1 : fq_zero());
  *out = fq_mul(x, y);
}

CBT_FN void bls_prod(int r, const bls_pd& d, fq* out) {
  bls_prod_core(r, d.a, d.xf, d.b, d.b16, out);
}

CBT_FN void fq_acc(uint32_t* S, const fq& x) {
  S[0] = cbt_add_cc(S[0], x.w[0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS - 1; k++) S[k] = cbt_addc_cc(S[k], x.w[k]);
  S[FQ_WORDS - 1] = cbt_addc(S[FQ_WORDS - 1], x.w[FQ_WORDS - 1]);
}

// one output component: D = (comp ? Ss - S0 : S0) - S1 + 12 p over the ns
// slots g0.. (below 18p), then 3 D +- 2 ex if ex is set, reduced once
CBT_CALL void bls_fold_core(int comp, int ns, int g0, int g1, int g2, int g3,
                            int g4, int g5, const fq* ex, int ex_neg,
                            fq* dst, const fq* v) {
  uint32_t S[3][FQ_WORDS];
#pragma unroll
  for (int r = 0; r < 3; r++)
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) S[r][k] = 0;
#pragma unroll
  for (int n = 0; n < 6; n++) {
    if (n >= ns) break;
    const int g = n == 0 ? g0 : n == 1 ? g1 : n == 2 ? g2
                : n == 3 ? g3 : n == 4 ? g4 : g5;
    const fq x0 = v[3 * g], x1 = v[3 * g + 1], x2 = v[3 * g + 2];
    fq_acc(S[0], x0);
    fq_acc(S[1], x1);
    fq_acc(S[2], x2);
  }
  const uint32_t c = comp ? 0xffffffffu : 0u;
  uint32_t D[FQ_WORDS + 1];
  // D = X + 12p - S1 - Y, X = comp ? Ss : S0, Y = comp ? S0 : 0
  D[0] = cbt_add_cc((S[2][0] & c) | (S[0][0] & ~c), fq_p12_word(0));
#pragma unroll
  for (int k = 1; k < FQ_WORDS; k++)
    D[k] = cbt_addc_cc((S[2][k] & c) | (S[0][k] & ~c), fq_p12_word(k));
  D[FQ_WORDS] = cbt_addc(0, fq_p12_word(FQ_WORDS));
  D[0] = cbt_sub_cc(D[0], S[1][0]);
#pragma unroll
  for (int k = 1; k < FQ_WORDS; k++) D[k] = cbt_subc_cc(D[k], S[1][k]);
  D[FQ_WORDS] = cbt_subc(D[FQ_WORDS], 0);
  D[0] = cbt_sub_cc(D[0], S[0][0] & c);
#pragma unroll
  for (int k = 1; k < FQ_WORDS; k++) D[k] = cbt_subc_cc(D[k], S[0][k] & c);
  D[FQ_WORDS] = cbt_subc(D[FQ_WORDS], 0);
  if (ex) {
    // 3 D + 2 e, e = ex or p - ex: (D << 1) + D, then + (e << 1)
    const fq e = ex_neg ? fq_p_minus(*ex) : *ex;
    uint32_t T[FQ_WORDS + 1];
    T[0] = D[0] << 1;
#pragma unroll
    for (int k = 1; k <= FQ_WORDS; k++) T[k] = (D[k] << 1) | (D[k - 1] >> 31);
    D[0] = cbt_add_cc(D[0], T[0]);
#pragma unroll
    for (int k = 1; k < FQ_WORDS; k++) D[k] = cbt_addc_cc(D[k], T[k]);
    D[FQ_WORDS] = cbt_addc(D[FQ_WORDS], T[FQ_WORDS]);
    D[0] = cbt_add_cc(D[0], e.w[0] << 1);
#pragma unroll
    for (int k = 1; k < FQ_WORDS; k++)
      D[k] = cbt_addc_cc(D[k], (e.w[k] << 1) | (e.w[k - 1] >> 31));
    D[FQ_WORDS] = cbt_addc(D[FQ_WORDS], e.w[FQ_WORDS - 1] >> 31);
  }
  *dst = fq_reduce13(D);
}

CBT_FN void bls_fold(const bls_fd& d, const fq* v) {
  bls_fold_core(d.comp, d.ns, d.g[0], d.g[1], d.g[2], d.g[3], d.g[4], d.g[5],
                d.ex, d.ex_neg, d.dst, v);
}

CBT_FN fq* fq2_comp(fq2* a, int c) { return c ? &a->c1 : &a->c0; }

// the transform of a pair whose degree i + j >= lim gets xi; cj negates
CBT_FN int bls_xf(bool xi, bool neg) {
  return xi ? (neg ? XF_NXI : XF_XI) : (neg ? XF_NEG : XF_ID);
}

// --- Fq12 operations (x, y, out in shared memory; out may alias x or y) -----

// out = x * y, x conjugated first if cj. Group g = 6 i + j.
CBT_FN void f12_mul_pd(int t, const fq2* x, const fq2* y, bool cj,
                       bls_smem* s) {
  if (t >= 108) return;
  const int g = t / 3, i = g / 6, j = g % 6;
  const bls_pd d = {x + i, bls_xf(i + j >= 6, cj && (i & 1)), y + j, 0};
  bls_prod(t % 3, d, &s->v[t]);
}

CBT_FN void f12_mul_fd(int t, fq2* out, bls_smem* s) {
  if (t >= 12) return;
  const int k = t >> 1;
  bls_fd d = {fq2_comp(out + k, t & 1), t & 1, 6, {0}, 0, 0};
  for (int i = 0; i < 6; i++) d.g[i] = 6 * i + (k - i + 6) % 6;
  bls_fold(d, s->v);
}

CBT_FN void f12_mul_block(bls_smem* s, fq2* out, const fq2* x, const fq2* y,
                          bool cj) {
  BLS_T;
  BLS_STEP(f12_mul_pd(t, x, y, cj, s));
  BLS_STEP(f12_mul_fd(t, out, s));
}

// out = x * y for y with three coefficients y[jj] at degrees deg[jj]
// (a line c0 + c3 w^3 + c5 w^5 as 16-bit limbs y16 [3][2][24], or Fq2
// values y at degrees 0, 2, 4), x conjugated first if cj. Group 3 i + jj.
CBT_FN void f12_mul3_pd(int t, const fq2* x, const fq2* y,
                        const int32_t* y16, int d1, int d2, bool cj,
                        bls_smem* s) {
  if (t >= 54) return;
  const int g = t / 3, i = g / 3, jj = g % 3;
  const int deg = jj == 0 ? 0 : (jj == 1 ? d1 : d2);
  const bls_pd d = {x + i, bls_xf(i + deg >= 6, cj && (i & 1)),
                    y ? y + jj : 0, y ? 0 : y16 + jj * 48};
  bls_prod(t % 3, d, &s->v[t]);
}

CBT_FN void f12_mul3_fd(int t, fq2* out, int d1, int d2, bls_smem* s) {
  if (t >= 12) return;
  const int k = t >> 1;
  bls_fd d = {fq2_comp(out + k, t & 1), t & 1, 3, {0}, 0, 0};
  d.g[0] = 3 * k;
  d.g[1] = 3 * ((k - d1 + 6) % 6) + 1;
  d.g[2] = 3 * ((k - d2 + 6) % 6) + 2;
  bls_fold(d, s->v);
}

CBT_FN void f12_mul3_block(bls_smem* s, fq2* out, const fq2* x,
                           const fq2* y, const int32_t* y16, int d1, int d2,
                           bool cj) {
  BLS_T;
  BLS_STEP(f12_mul3_pd(t, x, y, y16, d1, d2, cj, s));
  BLS_STEP(f12_mul3_fd(t, out, d1, d2, s));
}

// out = x^2: the 15 cross pairs i < j (groups 0..14, in the order below)
// and the 6 diagonal ones (groups 15..20); the fold lists each cross pair
// twice. Even k: pairs (k/2, k/2) and (k/2 + 3, k/2 + 3) and two cross
// pairs; odd k: three cross pairs.
CBT_FN int bls_cross(int i, int j) {   // group of the cross pair i < j
  return i * (9 - i) / 2 + j - 1;
}

CBT_FN void f12_sq_pd(int t, const fq2* x, int base, bls_smem* s) {
  if (t >= 63) return;
  const int g = t / 3;
  // the cross pairs' (i, j) in group order, 3 bits a group
  const int i = g >= 15 ? g - 15 : (int)((0x11b491248000ull >> (3 * g)) & 7);
  const int j = g >= 15 ? g - 15 : (int)((0x16cb1d8d58d1ull >> (3 * g)) & 7);
  const bls_pd d = {x + i, bls_xf(i + j >= 6, false), x + j, 0};
  bls_prod(t % 3, d, &s->v[3 * base + t]);
}

CBT_FN void f12_sq_fd(int t, fq2* out, int base, bls_smem* s) {
  if (t >= 12) return;
  const int k = t >> 1;
  // slot i: the pair (i, (k - i) mod 6), so a cross pair comes once from
  // each side and a diagonal one once
  bls_fd d = {fq2_comp(out + k, t & 1), t & 1, 6, {0}, 0, 0};
#pragma unroll
  for (int i = 0; i < 6; i++) {
    const int j = (k - i + 6) % 6;
    d.g[i] = base + (i == j ? 15 + i : i < j ? bls_cross(i, j) : bls_cross(j, i));
  }
  bls_fold(d, s->v);
}

CBT_FN void f12_sq_block(bls_smem* s, fq2* out, const fq2* x) {
  BLS_T;
  BLS_STEP(f12_sq_pd(t, x, 0, s));
  BLS_STEP(f12_sq_fd(t, out, 0, s));
}

// out = x^2 for x in the cyclotomic subgroup (Granger-Scott): for the
// pairs (x_i, y_i) = (a_i, a_{i+3}), i < 3, groups 3i: x_i^2, 3i + 1:
// (xi y_i) y_i, 3i + 2: x_i y_i (times xi for i = 2). Then coefficient k is
// 3 T_k - 2 a_k (k even, T = x_i^2 + xi y_i^2 of i = k/2) or 3 T_k + 2 a_k
// (k odd, T = 2 x_i y_i of i = 0, 1 for k = 3, 5 and xi 2 x_2 y_2 for k = 1).
CBT_FN void f12_cyc_pd(int t, const fq2* x, bls_smem* s) {
  if (t >= 27) return;
  const int g = t / 3, i = g / 3, kind = g % 3;
  const bls_pd d = {x + (kind == 1 ? i + 3 : i),
                    kind == 1 || (kind == 2 && i == 2) ? XF_XI : XF_ID,
                    x + (kind == 0 ? i : i + 3), 0};
  bls_prod(t % 3, d, &s->v[t]);
}

CBT_FN void f12_cyc_fd(int t, fq2* out, const fq2* x, bls_smem* s) {
  if (t >= 12) return;
  const int k = t >> 1, c = t & 1;
  const fq* ex = fq2_comp((fq2*)x + k, c);
  bls_fd d = {fq2_comp(out + k, c), c, 2, {0}, ex, !(k & 1)};
  if (k & 1) {
    const int i = ((k + 3) % 6) / 2;
    d.g[0] = d.g[1] = 3 * i + 2;
  } else {
    d.g[0] = 3 * (k / 2);
    d.g[1] = 3 * (k / 2) + 1;
  }
  bls_fold(d, s->v);
}

CBT_FN void f12_cyc_block(bls_smem* s, fq2* out, const fq2* x) {
  BLS_T;
  BLS_STEP(f12_cyc_pd(t, x, s));
  BLS_STEP(f12_cyc_fd(t, out, x, s));
}


// --- small phases: explicit groups and outputs --------------------------------

// an Fq2 output: both components of dst from slots g0.. (ns of them)
CBT_FN bls_fd bls_out(fq2* dst, int c, int ns, int g0, int g1, int g2) {
  bls_fd d = {fq2_comp(dst, c), c, ns, {g0, g1, g2, 0, 0, 0}, 0, 0};
  return d;
}

// the Fq6 cofactors of den = (u0, u2, u4) (groups 21..26, after a squaring's
// 21): A = u0^2 - xi u2 u4, B = xi u4^2 - u0 u2, C = u2^2 - u0 u4 into
// c6[0..2] (fold threads 12..17)
CBT_FN void bls_cof_pd(int t, bls_smem* s) {
  if (t < 63 || t >= 81) return;
  const fq2* u = s->u;
  const int g = t / 3 - 21;
  const fq2* a[6] = {u, u + 2, u + 4, u, u + 2, u};
  const fq2* b[6] = {u, u + 4, u + 4, u + 2, u + 2, u + 4};
  const int xf[6] = {XF_ID, XF_NXI, XF_XI, XF_NEG, XF_ID, XF_NEG};
  const bls_pd d = {a[g], xf[g], b[g], 0};
  bls_prod(t % 3, d, &s->v[t]);
}

CBT_FN void bls_cof_fd(int t, bls_smem* s) {
  if (t < 12 || t >= 18) return;
  const int q = (t - 12) >> 1;
  bls_fold(bls_out(s->c6 + q, t & 1, 2, 21 + 2 * q, 22 + 2 * q, 0), s->v);
}

// up to 6 explicit Fq2 products a_g xf_g * b_g (groups 0..ng-1) and Fq2
// outputs dst_o = the sum of slots sl[o][0..ns-1]
struct bls_small {
  int ng, no, ns;
  const fq2* a[6];
  int xf[6];
  const fq2* b[6];
  fq2* dst[6];
  int sl[6][3];
};

CBT_FN void bls_small_block(bls_smem* s, const bls_small& q) {
  BLS_T;
  BLS_STEP(if (t < 3 * q.ng) {
    const bls_pd d = {q.a[t / 3], q.xf[t / 3], q.b[t / 3], 0};
    bls_prod(t % 3, d, &s->v[t]);
  });
  BLS_STEP(if (t < 2 * q.no) {
    const int o = t >> 1;
    bls_fold(bls_out(q.dst[o], t & 1, q.ns, q.sl[o][0], q.sl[o][1],
                     q.sl[o][2]), s->v);
  });
}

// dst = src^-1 in Fq2 (0 for 0): the norm conj(src) src = src0^2 + src1^2
// in Fq (into c6[4]), its Fermat inverse on one thread (c6[5]), then
// conj(src) / norm. dst may alias src.
CBT_FN void bls_f2_inv_block(bls_smem* s, fq2* dst, const fq2* src) {
  BLS_T;
  fq2* c6 = s->c6;
  {
    const bls_small q = {1, 1, 1, {src}, {XF_CONJ}, {src}, {c6 + 4}, {{0}}};
    bls_small_block(s, q);
  }
  BLS_STEP(if (t == 0) {
    c6[5].c0 = fq_inv(c6[4].c0);
    c6[5].c1 = fq_zero();
  });
  const bls_small q = {1, 1, 1, {src}, {XF_CONJ}, {c6 + 5}, {dst}, {{0}}};
  bls_small_block(s, q);
}

// den^-1 for den = conj(x) x, an Fq6 element (its even coefficients, into
// u): the cofactors A = u0^2 - xi u2 u4, B = xi u4^2 - u0 u2, C = u2^2 - u0 u4
// (c6[0..2]), F = u0 A + xi (u2 C + u4 B) (c6[3]) in Fq2 and its inverse,
// then den^-1 = (A, B, C) F^-1 into c6[0..2]. With sq, the cofactors'
// phase also squares x into m.
CBT_FN void bls_den_inv(bls_smem* s, const fq2* x, bool sq) {
  BLS_T;
  f12_mul_block(s, s->u, x, x, true);                // den = conj(x) x
  BLS_STEP(if (sq) f12_sq_pd(t, x, 0, s); bls_cof_pd(t, s));
  BLS_STEP(if (sq) f12_sq_fd(t, s->m, 0, s); bls_cof_fd(t, s));
  fq2* c6 = s->c6;
  const fq2* u = s->u;
  {
    const bls_small q = {3, 1, 3, {u, u + 2, u + 4}, {XF_ID, XF_XI, XF_XI},
                         {c6, c6 + 2, c6 + 1}, {c6 + 3}, {{0, 1, 2}}};
    bls_small_block(s, q);
  }
  bls_f2_inv_block(s, c6 + 3, c6 + 3);
  const bls_small q = {3, 3, 1, {c6, c6 + 1, c6 + 2},
                       {XF_ID, XF_ID, XF_ID}, {c6 + 3, c6 + 3, c6 + 3},
                       {c6, c6 + 1, c6 + 2}, {{0}, {1}, {2}}};
  bls_small_block(s, q);
}

// out = x^-1 = conj(x) den^-1 (0 for 0)
CBT_FN void f12_inv_block(bls_smem* s, fq2* out, const fq2* x) {
  bls_den_inv(s, x, false);
  f12_mul3_block(s, out, x, s->c6, 0, 2, 4, true);
}

// The easy part of the final exponentiation of the Miller product f
// (s->f, before the conjugation that x < 0 asks for): for fc = conj(f) it
// is m = conj(fc) fc^-1 = f conj(f)^-1 = f^2 den^-1, den = conj(f) f, then
// m = frob2(m) m, into s->m (s->gam holds the Frobenius scalars).
CBT_FN void bls_easy_part(bls_smem* s) {
  bls_den_inv(s, s->f, true);                        // m = f^2
  f12_mul3_block(s, s->u, s->m, s->c6, 0, 2, 4, false);  // u = f^2 den^-1
  const fq2* u = s->u;
  const bls_small q = {6, 6, 1, {u, u + 1, u + 2, u + 3, u + 4, u + 5},
                       {XF_ID, XF_ID, XF_ID, XF_ID, XF_ID, XF_ID},
                       {s->gam, s->gam + 1, s->gam + 2, s->gam + 3,
                        s->gam + 4, s->gam + 5},
                       {s->m, s->m + 1, s->m + 2, s->m + 3, s->m + 4,
                        s->m + 5},
                       {{0}, {1}, {2}, {3}, {4}, {5}}};
  bls_small_block(s, q);                             // m = frob2(u)
  f12_mul_block(s, s->m, s->m, s->u, false);         // m = frob2(u) u
}

// --- the lanes ----------------------------------------------------------------

// Fq12 element (i, c) of lane `lane` in the (6, 2, 24, B) layout
CBT_FN long bls_elem(int i, int c, int lane, int b) {
  return (long)(i * 2 + c) * 24 * b + lane;
}

CBT_FN void bls_load(int t, fq2* dst, const int32_t* arr, int lane, int b) {
  if (t < 12)
    *fq2_comp(dst + (t >> 1), t & 1) =
        fq_load16(arr + bls_elem(t >> 1, t & 1, lane, b), b);
}

// threads t < 12 store x; thread 0 writes the verdict x == 1
CBT_FN void bls_store(int t, int32_t* out, uint8_t* ok, const fq2* x,
                      int lane, int b) {
  if (t < 12)
    fq_store16(out + bls_elem(t >> 1, t & 1, lane, b), b,
               (t & 1) ? x[t >> 1].c1 : x[t >> 1].c0);
  if (t == 0) {
    bool one = fq_eq(x[0].c0, fq_one());
    for (int i = 0; i < 6; i++) {
      one = one && fq_eq(x[i].c1, fq_zero());
      if (i) one = one && fq_eq(x[i].c0, fq_zero());
    }
    ok[lane] = one ? 1 : 0;
  }
}

// acc = m^e for MSB-first bits (bits[0] = 1), left to right with a sliding
// window of up to BLS_WIN bits that ends on a one: the odd powers m^1, m^3,
// ..., m^31 first (one squaring, 15 products), then a squaring a bit and
// one product a window: 227 products for HARD_BITS where square-and-
// multiply takes 632. The bits are public and the same for every lane, so
// no block diverges. cyc: the squarings are cyclotomic (m after the easy
// part). Uses u.
CBT_FN void bls_sq_block(bls_smem* s, fq2* out, const fq2* x, bool cyc) {
  if (cyc) f12_cyc_block(s, out, x);
  else f12_sq_block(s, out, x);
}

CBT_FN void bls_pow(bls_smem* s, fq2* acc, const fq2* m,
                    const int32_t* bits, int nbits, bool cyc) {
  BLS_T;
  BLS_STEP(if (t < 6) s->pw[0][t] = m[t]);
  bls_sq_block(s, s->u, m, cyc);
  for (int k = 1; k < (1 << (BLS_WIN - 1)); k++)
    f12_mul_block(s, s->pw[k], s->pw[k - 1], s->u, false);
  bool first = true;
  for (int i = 0; i < nbits;) {
    if (!bits[i]) {
      bls_sq_block(s, acc, acc, cyc);
      i++;
      continue;
    }
    int j = (i + BLS_WIN < nbits ? i + BLS_WIN : nbits) - 1;
    while (!bits[j]) j--;
    int val = 0;
    for (int q = i; q <= j; q++) val = 2 * val + bits[q];
    if (first) {
      BLS_STEP(if (t < 6) acc[t] = s->pw[val >> 1][t]);
      first = false;
    } else {
      for (int q = i; q <= j; q++) bls_sq_block(s, acc, acc, cyc);
      f12_mul_block(s, acc, acc, s->pw[val >> 1], false);
    }
    i = j + 1;
  }
}

CBT_FN void bls_hard_pow_lane(bls_smem* s, const int32_t* arr,
                              const int32_t* bits, int nbits, int32_t* out,
                              uint8_t* ok, int lane, int b) {
  BLS_T;
  BLS_STEP(bls_load(t, s->m, arr, lane, b); bls_load(t, s->f, arr, lane, b));
  bls_pow(s, s->f, s->m, bits, nbits, false);
  BLS_STEP(bls_store(t, out, ok, s->f, lane, b));
}

#define MILLER_STEPS 63
#define MILLER_SLOT 144   // int32 limbs of one line: 3 coefficients x 2 x 24

// Issue the copies of step st's four lines (pairs x phases, 576 limbs, each
// 4 bytes at stride b) into buffer st & 1: cp.async on the card, so the
// step before runs while they land; plain copies on the host.
CBT_FN void bls_fetch(int t, bls_smem* s, const int32_t* lines, int st,
                      int lane, int b) {
  int32_t* dst = &s->line[st & 1][0][0][0][0];
  const int32_t* src = lines + (long)st * 4 * MILLER_SLOT * b + lane;
  for (int e = t; e < 4 * MILLER_SLOT; e += BLS_THREADS) {
#if defined(__CUDA_ARCH__)
    const unsigned sa = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                 "l"(src + (long)e * b));
#else
    dst[e] = src[(long)e * b];
#endif
  }
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait for this thread's copies of step st and mark each slot that is not
// the identity line (ONE, 0, 0) in live[st & 1]: a zero-bit addition slot,
// an absent pair and a pad lane carry it, and a product by ONE is exact,
// so those products are skipped
CBT_FN void bls_fetch_wait(int t, bls_smem* s, int st) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
  const int32_t* src = &s->line[st & 1][0][0][0][0];
  uint32_t live = 0;
  for (int e = t; e < 4 * MILLER_SLOT; e += BLS_THREADS) {
    const int l = e % MILLER_SLOT;
    const uint32_t want =
        l < 24 ? (fq_one().w[l >> 1] >> ((l & 1) * 16)) & 0xffffu : 0u;
    if ((uint32_t)src[e] != want) live |= 1u << (e / MILLER_SLOT);
  }
#if defined(__CUDA_ARCH__)
  if (live) atomicOr(&s->live[st & 1], live);
#else
  s->live[st & 1] |= live;
#endif
}

// The fused lane: the Miller scan over the host's lines (f = 1; a general
// squaring and the live line products a step), the easy part and the
// cyclotomic hard chain.
CBT_FN void bls_miller_lane(bls_smem* s, const int32_t* lines,
                            const int32_t* bits, int nbits, int32_t* out,
                            uint8_t* ok, int lane, int b) {
  BLS_T;
  BLS_STEP(if (t < 12) *fq2_comp(s->f + (t >> 1), t & 1) =
               t == 0 ? fq_one() : fq_zero();
           if (t >= 12 && t < 24) *fq2_comp(s->gam + ((t - 12) >> 1), t & 1) =
               (t & 1) ? fq_zero() : fq_gamma2((t - 12) >> 1);
           if (t == 0) s->live[0] = 0;
           bls_fetch(t, s, lines, 0, lane, b));
  BLS_STEP(bls_fetch_wait(t, s, 0));
  for (int st = 0; st < MILLER_STEPS; st++) {
    const int buf = st & 1;
    if (st + 1 < MILLER_STEPS)
      BLS_STEP(if (t == 0) s->live[buf ^ 1] = 0;
               bls_fetch(t, s, lines, st + 1, lane, b));
    f12_sq_block(s, s->f, s->f);
    const uint32_t live = s->live[buf];
    for (int slot = 0; slot < 4; slot++)
      if ((live >> slot) & 1u)
        f12_mul3_block(s, s->f, s->f, 0, &s->line[buf][slot][0][0][0], 3,
                       5, false);
    if (st + 1 < MILLER_STEPS) BLS_STEP(bls_fetch_wait(t, s, st + 1));
  }
  bls_easy_part(s);
  BLS_STEP(if (t < 6) s->f[t] = s->m[t]);
  bls_pow(s, s->f, s->m, bits, nbits, true);
  BLS_STEP(bls_store(t, out, ok, s->f, lane, b));
}
