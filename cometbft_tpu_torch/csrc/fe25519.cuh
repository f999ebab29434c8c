// GF(2^255-19) and edwards25519 arithmetic for the port's CUDA kernels.
//
// Inside a kernel a field element is 8 little-endian 32-bit words
// (radix 2^32), any value in [0, 2^256) standing for its residue mod p.
// A product is a 8x8 schoolbook of 32x32->64-bit multiply-adds (64
// IMAD.WIDE), a squaring the 36 distinct ones (28 cross products doubled
// by a shift, 8 squares); both fold by 2^256 = 38 (mod p). Every carry
// is an explicit 64-bit accumulator, so no bound depends on lazy limbs:
//   - mul:  c + a_i*b_j + t <= (2^32-1)^2 + 2(2^32-1) = 2^64 - 1;
//   - add:  a carry out of 2^256 is folded as +38; a second carry can
//           only leave a value < 38 in word 0, so the last +38 cannot
//           carry;
//   - sub:  a borrow out of 2^256 is folded as -38; a second borrow can
//           only leave a value >= 2^256 - 37, so the last -38 cannot
//           borrow.
//
// At the kernel boundary the layout is the JAX package's: 16 limbs of 16
// bits in int32, limb axis leading, lanes minor, every limb in
// [0, 2^16). fe_load16 relies on that bound; fe_store16 produces it.
// The JAX kernels instead kept 16-bit limbs inside (uint32 products,
// int32 column sums, 4p added before each subtraction, an arithmetic
// shift deciding the conditional subtraction of p); the radix-2^32 form
// here needs none of those offsets, and fe_canon decides x >= p from the
// borrow of x - p the same way.
//
// The functions are host-callable too, so the arithmetic can be checked
// against Python integers with a host compiler.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define CBT_FN __host__ __device__ __forceinline__
#else
#define CBT_FN static inline
#endif

struct fe {
  uint32_t w[8];
};

struct ge {  // extended twisted-Edwards coordinates (X:Y:Z:T)
  fe x, y, z, t;
};

CBT_FN fe fe_small(uint32_t v) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0;
  r.w[0] = v;
  return r;
}

CBT_FN fe fe_d() {
  fe r = {{0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du,
           0x7779e898u, 0x8cc74079u, 0x2b6ffe73u, 0x52036ceeu}};
  return r;
}

CBT_FN fe fe_2d() {
  fe r = {{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
           0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}};
  return r;
}

CBT_FN fe fe_sqrtm1() {
  fe r = {{0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,
           0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u}};
  return r;
}

// word i of p = 2^255 - 19
CBT_FN uint32_t p_word(int i) {
  return i == 0 ? 0xffffffedu : (i == 7 ? 0x7fffffffu : 0xffffffffu);
}

CBT_FN fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  c *= 38;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += r.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  r.w[0] += (uint32_t)c * 38u;
  return r;
}

CBT_FN fe fe_sub(const fe& a, const fe& b) {
  fe r;
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - br;
    r.w[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  uint32_t sub = br * 38u;
  br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)r.w[i] - (i == 0 ? sub : 0u) - br;
    r.w[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  r.w[0] -= br * 38u;
  return r;
}

CBT_FN fe fe_neg(const fe& a) { return fe_sub(fe_small(0), a); }

// 512-bit t (16 words) -> 256 bits, by 2^256 = 38 (mod p).
CBT_FN fe fe_reduce512(const uint32_t* t) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[i] + (uint64_t)t[i + 8] * 38u;
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  c *= 38;  // c <= 38 here
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += r.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  r.w[0] += (uint32_t)c * 38u;
  return r;
}

CBT_FN fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  return fe_reduce512(t);
}

// a^2: the 28 cross products a_i a_j (i < j) once, doubled by a shift
// (their sum is below 2^511), then the 8 squares a_i^2 on the diagonal:
// 36 products where fe_mul(a, a) pays 64. The carries keep fe_mul's
// bound: c + a_i*a_j + t <= 2^64 - 1.
CBT_FN fe fe_sq(const fe& a) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (uint64_t)a.w[i] * a.w[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
#pragma unroll
  for (int i = 15; i > 0; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] * a.w[i] + t[2 * i];
    t[2 * i] = (uint32_t)c;
    c >>= 32;
    c += t[2 * i + 1];
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce512(t);
}

CBT_FN fe fe_nsq(fe x, int n) {
  for (int i = 0; i < n; i++) x = fe_sq(x);
  return x;
}

// x - p when x >= p, else x: the borrow out of x - p decides.
CBT_FN fe fe_cond_sub_p(const fe& x) {
  fe d;
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)x.w[i] - p_word(i) - br;
    d.w[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  uint32_t keep = 0u - br;  // all ones when x < p
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = (x.w[i] & keep) | (d.w[i] & ~keep);
  return r;
}

// [0, p) representative. 2^256 = 2p + 38, so two subtractions suffice.
CBT_FN fe fe_canon(const fe& x) { return fe_cond_sub_p(fe_cond_sub_p(x)); }

CBT_FN bool fe_is_zero(const fe& a) {
  fe c = fe_canon(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= c.w[i];
  return acc == 0;
}

CBT_FN bool fe_eq(const fe& a, const fe& b) { return fe_is_zero(fe_sub(a, b)); }

CBT_FN uint32_t fe_parity(const fe& a) { return fe_canon(a).w[0] & 1u; }

CBT_FN fe fe_select(bool c, const fe& a, const fe& b) { return c ? a : b; }

// z^((p-5)/8) = z^(2^252 - 3), the ref10 chain: 251 squarings, 11 muls.
CBT_FN fe fe_pow2523(const fe& z) {
  fe t0 = fe_sq(z);
  fe t1 = fe_nsq(t0, 2);
  t1 = fe_mul(z, t1);
  t0 = fe_mul(t0, t1);
  t0 = fe_sq(t0);
  t0 = fe_mul(t1, t0);
  t1 = fe_nsq(t0, 5);
  t0 = fe_mul(t1, t0);
  t1 = fe_nsq(t0, 10);
  t1 = fe_mul(t1, t0);
  fe t2 = fe_nsq(t1, 20);
  t1 = fe_mul(t2, t1);
  t1 = fe_nsq(t1, 10);
  t0 = fe_mul(t1, t0);
  t1 = fe_nsq(t0, 50);
  t1 = fe_mul(t1, t0);
  t2 = fe_nsq(t1, 100);
  t1 = fe_mul(t2, t1);
  t1 = fe_nsq(t1, 50);
  t0 = fe_mul(t1, t0);
  t0 = fe_nsq(t0, 2);
  return fe_mul(t0, z);
}

// --- boundary layout: 16 limbs of 16 bits, limb l at base[l * stride] ----

CBT_FN fe fe_load16(const int32_t* base, long stride) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.w[k] = (uint32_t)base[(2 * k) * stride] |
             ((uint32_t)base[(2 * k + 1) * stride] << 16);
  return r;
}

CBT_FN void fe_store16(int32_t* base, long stride, const fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    base[(2 * k) * stride] = (int32_t)(a.w[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(a.w[k] >> 16);
  }
}

// point: coord c, limb l at base[(c * 16 + l) * stride]
CBT_FN ge ge_load16(const int32_t* base, long stride) {
  ge p;
  p.x = fe_load16(base, stride);
  p.y = fe_load16(base + 16 * stride, stride);
  p.z = fe_load16(base + 32 * stride, stride);
  p.t = fe_load16(base + 48 * stride, stride);
  return p;
}

CBT_FN void ge_store16(int32_t* base, long stride, const ge& p) {
  fe_store16(base, stride, p.x);
  fe_store16(base + 16 * stride, stride, p.y);
  fe_store16(base + 32 * stride, stride, p.z);
  fe_store16(base + 48 * stride, stride, p.t);
}

// scratch layout: word k of coord c at base[(c * 8 + k) * stride]
CBT_FN fe fe_load_words(const uint32_t* base, long stride) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = base[k * stride];
  return r;
}

CBT_FN void fe_store_words(uint32_t* base, long stride, const fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) base[k * stride] = a.w[k];
}

CBT_FN ge ge_load_words(const uint32_t* base, long stride) {
  ge p;
  p.x = fe_load_words(base, stride);
  p.y = fe_load_words(base + 8 * stride, stride);
  p.z = fe_load_words(base + 16 * stride, stride);
  p.t = fe_load_words(base + 24 * stride, stride);
  return p;
}

CBT_FN void ge_store_words(uint32_t* base, long stride, const ge& p) {
  fe_store_words(base, stride, p.x);
  fe_store_words(base + 8 * stride, stride, p.y);
  fe_store_words(base + 16 * stride, stride, p.z);
  fe_store_words(base + 24 * stride, stride, p.t);
}

// --- group law -------------------------------------------------------------

CBT_FN ge ge_identity() {
  ge p;
  p.x = fe_small(0);
  p.y = fe_small(1);
  p.z = fe_small(1);
  p.t = fe_small(0);
  return p;
}

// add-2008-hwcd-3 (a = -1), complete: 9 fe_mul.
CBT_FN ge ge_add(const ge& p, const ge& q) {
  fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  fe c = fe_mul(fe_mul(p.t, fe_2d()), q.t);
  fe d = fe_mul(p.z, q.z);
  d = fe_add(d, d);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// dbl-2008-hwcd: 4 squarings + 4 muls, T unused.
CBT_FN ge ge_dbl(const ge& p) {
  fe a = fe_sq(p.x);
  fe b = fe_sq(p.y);
  fe c = fe_sq(p.z);
  c = fe_add(c, c);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

CBT_FN bool ge_is_identity(const ge& p) {
  return fe_is_zero(p.x) && fe_eq(p.y, p.z);
}

// --- per-lane bodies of the kernels ----------------------------------------

// ZIP-215 decode of one lane's 32 bytes (byte i at enc[i * stride]):
// y is taken from the bytes unreduced, x = u v^3 (u v^7)^((p-5)/8), the
// sqrt(-1) twist, the sign fix. Returns the validity flag.
CBT_FN bool ge_decompress(const int32_t* enc, long stride, ge* out) {
  fe y;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; j++)
      w |= ((uint32_t)enc[(4 * k + j) * stride] & 0xffu) << (8 * j);
    y.w[k] = w;
  }
  uint32_t sign = y.w[7] >> 31;
  y.w[7] &= 0x7fffffffu;

  fe one = fe_small(1);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, fe_d()), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow2523(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  bool ok_direct = fe_eq(vxx, u);
  bool ok_twisted = fe_eq(vxx, fe_neg(u));
  if (ok_twisted) x = fe_mul(x, fe_sqrtm1());
  if (fe_parity(x) != sign) x = fe_neg(x);
  out->x = x;
  out->y = y;
  out->z = one;
  out->t = fe_mul(x, y);
  return ok_direct || ok_twisted;
}
