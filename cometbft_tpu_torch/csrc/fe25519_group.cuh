// GF(2^255-19) arithmetic on an element spread over a group of G = 4
// consecutive threads of a warp, and the ZIP-215 decompression on it.
//
// Thread r (0..3) of a group holds words 2r and 2r+1 (radix 2^32) of the
// element as one 64-bit "pair" x_r, so the element is
// sum_r x_r 2^(64 r); as in fe25519.cuh, any value in [0, 2^256) stands
// for its residue mod p. Every function is called by all 4 threads of
// the group with the same arguments except their own pairs and their
// rank r, and every verdict (canonical form, zero, equality, parity) is
// group-wide: each thread returns the same value.
//
// The group exchanges values through two primitives, so the same code
// runs on the card and under a host test:
//   CBT_GROUP_SHFL(v, src)  the 32-bit v of group thread src (0..3);
//   CBT_GROUP_BALLOT(p)     the warp's ballot of p, rotated so that bit q
//                           is group thread q's: the group's verdicts are
//                           its low 4 bits, and the whole is 0 iff p is
//                           false on every thread of the warp.
// On the card they are __shfl_sync (width 4) and __ballot_sync over the
// full warp, so every thread of the warp must reach every call: no early
// exit, no call under a branch that differs between threads. A branch
// on a whole ballot being 0 is the same on the whole warp, so it may
// hold calls. A host test defines both before including this file (4
// std::threads in lockstep: the warp is the group).
//
// Product (grp_mul, grp_sq): a row split, not a column split. Thread r
// multiplies its own words a_2r, a_2r+1 by all 8 words of b (gathered by
// 4 64-bit shuffles): a 2 x 8 schoolbook (grp_rows), giving 10 words at
// word 2r, i.e. pairs P_0..P_4 at pair positions r..r+4. Pair position
// q >= 4 is worth 38 at q - 4 (2^256 = 38 mod p). Thread s collects P_k of
// thread s - k for k = 1..3 (3 more 64-bit shuffles), weight 38 when
// k > s (the source wrapped), adds its own P_0 and 38 P_4, and has a
// value below 2^105 spread as a pair plus a carry below 2^41 into the
// next pair; grp_carry settles those. A column split (thread r owns the
// product's columns 2r, 2r+1, 2r+8, 2r+9) needs, for each term, a
// weight of 1 or 38 chosen by r, or register arrays indexed by r, which
// on the card live in local memory; the row split keeps every register
// index static and leaves only the shuffle's source lane and three
// weights to r. A square is the product with b = a: 16 products per
// thread, where fe_sq pays 36 on one thread.
//
// grp_carry settles a value given as pairs x_r plus carries c_r < 2^32
// worth c_r 2^(64(r+1)), the carry of thread 3 worth 38 c_3 at word 0.
// One shuffle moves each carry up. Mostly no pair overflows then (the
// carry is below 2^38), and one ballot shows it for the whole warp.
// Otherwise the 1-bit ripple that can remain is resolved at once from
// two ballots: G (the pair overflowed) and P (the pair is all ones) are
// disjoint, and bit q of ((G|P) + G) ^ P is the carry into pair q, bit 4
// the carry out of the top. That top carry is
// added as 38 at word 0 and rippled the same way; it cannot carry out
// again: with cin < 2^38 per pair the total was < 2^256 + 2^231, so the
// top pair left is < 2^39.
// grp_sub adds a + ~b + (p - 37) = a - b + (2^256 - 1) + p - 37, which
// is a - b mod p, so a subtraction is an addition with carries <= 2.
// The canonical form subtracts p twice (2^256 = 2p + 38) with the same
// generate/propagate trick on the borrows.
#pragma once
#include <stdint.h>

#include "fe25519.cuh"

#if defined(__CUDACC__)
#define CBT_GFN __device__ __forceinline__
#ifndef CBT_GROUP_SHFL
CBT_GFN uint32_t cbt_group_ballot(bool p) {
  const uint32_t m = __ballot_sync(0xffffffffu, p);
  return __funnelshift_r(m, m, threadIdx.x & 28u);   // rotate: group first
}
#define CBT_GROUP_SHFL(v, src) __shfl_sync(0xffffffffu, (v), (src), 4)
#define CBT_GROUP_BALLOT(p) cbt_group_ballot(p)
#endif
#else
#define CBT_GFN static inline
#endif

CBT_GFN uint64_t grp_shfl64(uint64_t v, int src) {
  uint32_t lo = CBT_GROUP_SHFL((uint32_t)v, src);
  uint32_t hi = CBT_GROUP_SHFL((uint32_t)(v >> 32), src);
  return (uint64_t)hi << 32 | lo;
}

// pair r of a one-thread element (a constant)
CBT_GFN uint64_t grp_pair(const fe& a, int r) {
  uint64_t v = (uint64_t)a.w[1] << 32 | a.w[0];
  v = r == 1 ? ((uint64_t)a.w[3] << 32 | a.w[2]) : v;
  v = r == 2 ? ((uint64_t)a.w[5] << 32 | a.w[4]) : v;
  v = r == 3 ? ((uint64_t)a.w[7] << 32 | a.w[6]) : v;
  return v;
}

CBT_GFN uint64_t grp_small(uint32_t v, int r) { return r == 0 ? v : 0; }

// generate/propagate carry vector: bit q is the carry into pair q, bit 4
// the carry out of pair 3 (g and p disjoint 4-bit masks)
CBT_GFN uint32_t grp_ripple(uint32_t g, uint32_t p) {
  return ((g | p) + g) ^ p;
}

CBT_GFN uint64_t grp_carry(uint64_t x, uint32_t c, int r) {
  uint64_t cin = CBT_GROUP_SHFL(c, (r + 3) & 3);
  cin *= r == 0 ? 38u : 1u;                  // thread 3's carry: 2^256 = 38
  x += cin;                                   // cin < 2^38
  const uint32_t g = CBT_GROUP_BALLOT(x < cin);
  if (g == 0) return x;                       // no pair overflowed: done
  uint32_t cc = grp_ripple(g & 0xfu, CBT_GROUP_BALLOT(x == ~0ull) & 0xfu);
  x += (cc >> r) & 1u;
  uint64_t w = r == 0 ? (uint64_t)((cc >> 4) & 1u) * 38u : 0;
  x += w;
  cc = grp_ripple(CBT_GROUP_BALLOT(x < w) & 0xfu,
                  CBT_GROUP_BALLOT(x == ~0ull) & 0xfu);
  return x + ((cc >> r) & 1u);               // no carry out (see above)
}

CBT_GFN uint64_t grp_add(uint64_t a, uint64_t b, int r) {
  uint64_t x = a + b;
  return grp_carry(x, x < a ? 1u : 0u, r);
}

CBT_GFN uint64_t grp_sub(uint64_t a, uint64_t b, int r) {
  // pair r of p - 37 = 2^255 - 56
  const uint64_t k = r == 0 ? 0xffffffffffffffc8ull
                            : (r == 3 ? 0x7fffffffffffffffull : ~0ull);
  uint64_t x = a + ~b;
  uint32_t c = x < a ? 1u : 0u;
  x += k;
  c += x < k ? 1u : 0u;
  return grp_carry(x, c, r);
}

CBT_GFN uint64_t grp_neg(uint64_t a, int r) { return grp_sub(0, a, r); }

// t[0..9] = (a0 + 2^32 a1) * b, b in 8 words: below 2^320. On the card
// two PTX carry chains a row (the low halves of a_e b_j added at word
// e + j, then the high halves at e + j + 1): 33 multiply-adds where the
// 64-bit accumulator of fe_mul's rows compiles to about twice as many
// instructions. Elsewhere fe_mul's rows, with its carry bound.
CBT_GFN void grp_rows(uint32_t* t, uint32_t a0, uint32_t a1,
                      const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm("mul.lo.u32 %0, %10, %12;\n\t"
      "mul.lo.u32 %1, %10, %13;\n\t"
      "mul.lo.u32 %2, %10, %14;\n\t"
      "mul.lo.u32 %3, %10, %15;\n\t"
      "mul.lo.u32 %4, %10, %16;\n\t"
      "mul.lo.u32 %5, %10, %17;\n\t"
      "mul.lo.u32 %6, %10, %18;\n\t"
      "mul.lo.u32 %7, %10, %19;\n\t"
      "mad.hi.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %18, %7;\n\t"
      "madc.hi.u32 %8, %10, %19, 0;\n\t"
      "mad.lo.cc.u32 %1, %11, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %11, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %11, %18, %7;\n\t"
      "madc.lo.cc.u32 %8, %11, %19, %8;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mad.hi.cc.u32 %2, %11, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %11, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %11, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %11, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %11, %18, %8;\n\t"
      "madc.hi.u32 %9, %11, %19, %9;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]),
        "=&r"(t[5]), "=&r"(t[6]), "=&r"(t[7]), "=&r"(t[8]), "=&r"(t[9])
      : "r"(a0), "r"(a1), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#else
  const uint32_t a[2] = {a0, a1};
  for (int i = 0; i < 10; i++) t[i] = 0;
  for (int e = 0; e < 2; e++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a[e] * b[j] + t[e + j];
      t[e + j] = (uint32_t)c;
      c >>= 32;
    }
    t[e + 8] = (uint32_t)c;
  }
#endif
}

CBT_GFN uint64_t grp_mul(uint64_t a, uint64_t b, int r) {
  uint32_t bw[8], t[10];
#pragma unroll
  for (int q = 0; q < 4; q++) {
    uint64_t v = grp_shfl64(b, q);
    bw[2 * q] = (uint32_t)v;
    bw[2 * q + 1] = (uint32_t)(v >> 32);
  }
  grp_rows(t, (uint32_t)a, (uint32_t)(a >> 32), bw);
  // s0, s1: the weighted low and high words of the pairs landing here,
  // each term < 38 * 2^32, five terms: < 2^40
  uint64_t s0 = (uint64_t)t[0] + (uint64_t)t[8] * 38u;
  uint64_t s1 = (uint64_t)t[1] + (uint64_t)t[9] * 38u;
#pragma unroll
  for (int k = 1; k < 4; k++) {
    const int src = (r - k) & 3;
    const uint32_t w = k > r ? 38u : 1u;
    s0 += (uint64_t)CBT_GROUP_SHFL(t[2 * k], src) * w;
    s1 += (uint64_t)CBT_GROUP_SHFL(t[2 * k + 1], src) * w;
  }
  const uint64_t m = (s0 >> 32) + s1;         // < 2^41
  return grp_carry(m << 32 | (uint32_t)s0, (uint32_t)(m >> 32), r);
}

CBT_GFN uint64_t grp_sq(uint64_t a, int r) { return grp_mul(a, a, r); }

CBT_GFN uint64_t grp_nsq(uint64_t x, int n, int r) {
#pragma unroll 1
  for (int i = 0; i < n; i++) x = grp_sq(x, r);
  return x;
}

// x - p when x >= p, else x; the borrow of x - p decides, group-wide
CBT_GFN uint64_t grp_cond_sub_p(uint64_t x, int r) {
  const uint64_t pw = r == 0 ? 0xffffffffffffffedull
                             : (r == 3 ? 0x7fffffffffffffffull : ~0ull);
  const uint32_t bb = grp_ripple(CBT_GROUP_BALLOT(x < pw) & 0xfu,
                                 CBT_GROUP_BALLOT(x == pw) & 0xfu);
  const uint64_t d = x - pw - ((bb >> r) & 1u);
  return (bb >> 4) & 1u ? x : d;             // borrow out: x < p
}

CBT_GFN uint64_t grp_canon(uint64_t x, int r) {
  return grp_cond_sub_p(grp_cond_sub_p(x, r), r);
}

CBT_GFN bool grp_is_zero(uint64_t a, int r) {
  return (CBT_GROUP_BALLOT(grp_canon(a, r) != 0) & 0xfu) == 0;
}

CBT_GFN bool grp_eq(uint64_t a, uint64_t b, int r) {
  return grp_is_zero(grp_sub(a, b, r), r);
}

CBT_GFN uint32_t grp_parity(uint64_t a, int r) {
  return CBT_GROUP_BALLOT((grp_canon(a, r) & 1u) != 0) & 1u;
}

// c must be the same on the 4 threads (a group-wide verdict)
CBT_GFN uint64_t grp_select(bool c, uint64_t a, uint64_t b) {
  return c ? a : b;
}

// z^((p-5)/8) = z^(2^252 - 3), fe_pow2523's ref10 chain
CBT_GFN uint64_t grp_pow2523(uint64_t z, int r) {
  uint64_t t0 = grp_sq(z, r);
  uint64_t t1 = grp_nsq(t0, 2, r);
  t1 = grp_mul(z, t1, r);
  t0 = grp_mul(t0, t1, r);
  t0 = grp_sq(t0, r);
  t0 = grp_mul(t1, t0, r);
  t1 = grp_nsq(t0, 5, r);
  t0 = grp_mul(t1, t0, r);
  t1 = grp_nsq(t0, 10, r);
  t1 = grp_mul(t1, t0, r);
  uint64_t t2 = grp_nsq(t1, 20, r);
  t1 = grp_mul(t2, t1, r);
  t1 = grp_nsq(t1, 10, r);
  t0 = grp_mul(t1, t0, r);
  t1 = grp_nsq(t0, 50, r);
  t1 = grp_mul(t1, t0, r);
  t2 = grp_nsq(t1, 100, r);
  t1 = grp_mul(t2, t1, r);
  t1 = grp_nsq(t1, 50, r);
  t0 = grp_mul(t1, t0, r);
  t0 = grp_nsq(t0, 2, r);
  return grp_mul(t0, z, r);
}

// ZIP-215 decode, ge_decompress's semantics on a group: y is pair r of
// the 32 bytes (bytes 8r..8r+7, taken unreduced), x = u v^3 (u v^7)^
// ((p-5)/8), the sqrt(-1) twist, the sign fix; both sides of each
// choice are computed and selected, so no shuffle sits under a branch.
// Returns the validity flag (group-wide); *x, *y, *t get pair r of X,
// Y, T (Z = 1).
CBT_GFN bool grp_decompress(uint64_t y, int r, uint64_t* x_out,
                            uint64_t* y_out, uint64_t* t_out) {
  const uint32_t sign = CBT_GROUP_SHFL((uint32_t)(y >> 63), 3);
  y &= r == 3 ? 0x7fffffffffffffffull : ~0ull;
  const uint64_t one = grp_small(1, r);
  const uint64_t yy = grp_sq(y, r);
  const uint64_t u = grp_sub(yy, one, r);
  const uint64_t v = grp_add(grp_mul(yy, grp_pair(fe_d(), r), r), one, r);
  const uint64_t v3 = grp_mul(grp_sq(v, r), v, r);
  const uint64_t v7 = grp_mul(grp_sq(v3, r), v, r);
  uint64_t x = grp_mul(grp_mul(u, v3, r),
                       grp_pow2523(grp_mul(u, v7, r), r), r);
  const uint64_t vxx = grp_mul(v, grp_sq(x, r), r);
  const bool ok_direct = grp_eq(vxx, u, r);
  const bool ok_twisted = grp_eq(vxx, grp_neg(u, r), r);
  x = grp_select(ok_twisted, grp_mul(x, grp_pair(fe_sqrtm1(), r), r), x);
  x = grp_select(grp_parity(x, r) != sign, grp_neg(x, r), x);
  *x_out = x;
  *y_out = y;
  *t_out = grp_mul(x, y, r);
  return ok_direct || ok_twisted;
}
