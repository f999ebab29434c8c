// ed25519 signing and single-signature verification (RFC 8032) for the
// host, built by g++ (ops/_build.host_lib) into build/cometbft_tpu_torch/.
//
// It replaces the pure-Python oracle on the host paths that check or make
// one signature at a time: consensus vote intake (types/vote_set.py
// _check_signature), proposals and evidence, commits under the batch
// threshold, the farm's and ingest's narrow flushes, the SecretConnection
// handshake and chain generation. The JAX package uses the `cryptography`
// wheel there; the port may not import it.
//
// Field and group arithmetic come from ../fe25519.cuh (radix 2^32, the
// same code the CUDA kernels run; CBT_FN is `static inline` under g++).
// What is added here: SHA-512, the reduction mod L of a 512-bit value,
// strict point decoding, encoding, [s]B from a fixed-base comb table, and
// the joint [s]B - [k]A.
//
// Verification is strict and cofactorless: s < L, A decodes canonically
// (y < p, no x = 0 with the sign bit set), and the encoding of
// [s]B - [k]A must equal the 32 bytes of R. Every signature accepted here
// is ZIP-215-valid, so the caller re-checks only rejects against the
// ZIP-215 oracle and its verdict equals the oracle's on every input.
// Signing is deterministic RFC 8032; the signature bytes equal the
// oracle's.
//
// Key derivation and signing run in constant time: no branch and no
// memory address depends on the secret key or the nonce. [s]B reads each
// comb row by scanning all 16 entries with masked selects, the reduction
// mod L subtracts L through a mask, and the field and group code of
// fe25519.cuh is branch-free (the point addition is complete). The
// verify path works on public data only and its 4-bit window over k
// stays variable-time.
//
// C ABI for ctypes. No allocation: the caller passes the buffers.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "../fe25519.cuh"

namespace {

// --- SHA-512 (FIPS 180-4) ------------------------------------------------

const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL,
    0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL,
    0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL,
    0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL,
    0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL,
    0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL,
    0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL,
    0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL,
    0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL,
    0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL,
    0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL,
    0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL,
    0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL,
    0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline uint64_t ld64be(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return v;
}

struct Sha512 {
  uint64_t h[8];
  uint8_t buf[128];
  size_t fill;
  uint64_t total;

  Sha512() {
    static const uint64_t iv[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    memcpy(h, iv, sizeof h);
    fill = 0;
    total = 0;
  }

  void block(const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; ++i) w[i] = ld64be(p + 8 * i);
    for (int i = 16; i < 80; ++i) {
      uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
      uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 80; ++i) {
      uint64_t t1 = hh + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) +
                    ((e & f) ^ (~e & g)) + K512[i] + w[i];
      uint64_t t2 = (rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)) +
                    ((a & b) ^ (a & c) ^ (b & c));
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (fill) {
      size_t m = 128 - fill < n ? 128 - fill : n;
      memcpy(buf + fill, p, m);
      fill += m; p += m; n -= m;
      if (fill < 128) return;
      block(buf);
      fill = 0;
    }
    for (; n >= 128; p += 128, n -= 128) block(p);
    memcpy(buf, p, n);
    fill = n;
  }

  void final(uint8_t out[64]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero[128] = {0};
    size_t z = fill <= 112 ? 112 - fill : 240 - fill;
    update(zero, z);
    uint8_t len[16] = {0};
    for (int i = 0; i < 8; ++i) len[15 - i] = uint8_t(bits >> (8 * i));
    update(len, 16);
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) out[8 * i + j] = uint8_t(h[i] >> (56 - 8 * j));
  }
};

// --- scalars mod L = 2^252 + 27742317777372353535851937790883648493 -------

const uint64_t L64[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0,
                         0x1000000000000000ULL};

// 0 - bit for a bit in {0, 1}, behind an empty asm the optimiser cannot
// see through, so a select on the mask never turns into a branch.
inline uint64_t ct_mask(uint64_t bit) {
  uint64_t m = 0 - bit;
  __asm__("" : "+r"(m));
  return m;
}

// r - L when r >= L, else r (r < 2^256): the borrow out of r - L picks,
// through a mask.
inline void cond_sub_l(uint64_t r[4]) {
  uint64_t d[4], br = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 t = (unsigned __int128)r[i] - L64[i] - br;
    d[i] = (uint64_t)t;
    br = (uint64_t)(t >> 64) & 1;
  }
  uint64_t keep = ct_mask(br);  // all ones when r < L
  for (int i = 0; i < 4; ++i) r[i] = (r[i] & keep) | (d[i] & ~keep);
}

// x (8 little-endian 64-bit words) mod L, one bit at a time from the top:
// r stays below L < 2^253, so 2r + 1 fits in 254 bits.
void reduce512(const uint64_t x[8], uint64_t r[4]) {
  r[0] = r[1] = r[2] = r[3] = 0;
  for (int bit = 511; bit >= 0; --bit) {
    r[3] = (r[3] << 1) | (r[2] >> 63);
    r[2] = (r[2] << 1) | (r[1] >> 63);
    r[1] = (r[1] << 1) | (r[0] >> 63);
    r[0] = (r[0] << 1) | ((x[bit >> 6] >> (bit & 63)) & 1);
    cond_sub_l(r);
  }
}

void load_words(const uint8_t* b, int nwords, uint64_t* w) {
  for (int i = 0; i < nwords; ++i) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; --j) v = (v << 8) | b[8 * i + j];
    w[i] = v;
  }
}

void store_scalar(const uint64_t r[4], uint8_t out[32]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) out[8 * i + j] = uint8_t(r[i] >> (8 * j));
}

void digest_mod_l(const uint8_t d[64], uint8_t out[32]) {
  uint64_t x[8], r[4];
  load_words(d, 8, x);
  reduce512(x, r);
  store_scalar(r, out);
}

// (a * b + c) mod L for 256-bit a, b, c.
void muladd(const uint8_t a[32], const uint8_t b[32], const uint8_t c[32],
            uint8_t out[32]) {
  uint64_t x[4], y[4], z[4], p[8] = {0};
  load_words(a, 4, x);
  load_words(b, 4, y);
  load_words(c, 4, z);
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      unsigned __int128 t = (unsigned __int128)x[i] * y[j] + p[i + j] + carry;
      p[i + j] = (uint64_t)t;
      carry = t >> 64;
    }
    p[i + 4] = (uint64_t)carry;
  }
  unsigned __int128 carry = 0;
  for (int i = 0; i < 8; ++i) {
    unsigned __int128 t = (unsigned __int128)p[i] + (i < 4 ? z[i] : 0) + carry;
    p[i] = (uint64_t)t;
    carry = t >> 64;
  }
  uint64_t r[4];
  reduce512(p, r);
  store_scalar(r, out);
}

// verify's s only: public, so it may return early
bool scalar_lt_l(const uint8_t s[32]) {
  uint64_t r[4];
  load_words(s, 4, r);
  for (int i = 3; i >= 0; --i) {
    if (r[i] != L64[i]) return r[i] < L64[i];
  }
  return false;
}

// --- points ----------------------------------------------------------------

fe fe_from_bytes(const uint8_t b[32]) {
  fe r;
  for (int k = 0; k < 8; ++k)
    r.w[k] = uint32_t(b[4 * k]) | uint32_t(b[4 * k + 1]) << 8 |
             uint32_t(b[4 * k + 2]) << 16 | uint32_t(b[4 * k + 3]) << 24;
  return r;
}

// z^(p-2) = (z^(2^252-3))^8 * z^3
fe fe_invert(const fe& z) {
  fe t = fe_nsq(fe_pow2523(z), 3);
  return fe_mul(t, fe_mul(fe_sq(z), z));
}

void encode(const ge& p, uint8_t out[32]) {
  fe zi = fe_invert(p.z);
  fe x = fe_mul(p.x, zi);
  fe y = fe_canon(fe_mul(p.y, zi));
  for (int k = 0; k < 8; ++k)
    for (int j = 0; j < 4; ++j) out[4 * k + j] = uint8_t(y.w[k] >> (8 * j));
  out[31] |= uint8_t(fe_parity(x) << 7);
}

// RFC 8032 5.1.3: y must be below p, and x = 0 must not carry a sign bit.
bool decode_strict(const uint8_t b[32], ge* out) {
  fe y = fe_from_bytes(b);
  uint32_t sign = y.w[7] >> 31;
  y.w[7] &= 0x7fffffffu;
  bool high = y.w[7] == 0x7fffffffu;
  for (int k = 1; k < 7; ++k) high = high && y.w[k] == 0xffffffffu;
  if (high && y.w[0] >= 0xffffffedu) return false;
  int32_t enc[32];
  for (int i = 0; i < 32; ++i) enc[i] = b[i];
  if (!ge_decompress(enc, 1, out)) return false;
  if (sign && fe_is_zero(out->x)) return false;
  return true;
}

inline int nibble(const uint8_t s[32], int i) {
  return (s[i >> 1] >> (4 * (i & 1))) & 15;
}

// comb[i][j] = [j * 16^i]B, so [s]B = sum_i comb[i][nibble i of s].
struct BaseTable {
  ge t[64][16];
  BaseTable() {
    static const uint8_t benc[32] = {
        0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
        0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
        0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};
    ge b;
    decode_strict(benc, &b);
    for (int i = 0; i < 64; ++i) {
      t[i][0] = ge_identity();
      t[i][1] = b;
      for (int j = 2; j < 16; ++j) t[i][j] = ge_add(t[i][j - 1], b);
      for (int k = 0; k < 4; ++k) b = ge_dbl(b);
    }
  }
};

const BaseTable& base_table() {
  static const BaseTable table;  // thread-safe one-time initialisation
  return table;
}

// r = p where mask is all ones, r unchanged where it is 0
inline void ge_cmov(ge& r, const ge& p, uint32_t mask) {
  for (int k = 0; k < 8; ++k) {
    r.x.w[k] ^= mask & (r.x.w[k] ^ p.x.w[k]);
    r.y.w[k] ^= mask & (r.y.w[k] ^ p.y.w[k]);
    r.z.w[k] ^= mask & (r.z.w[k] ^ p.z.w[k]);
    r.t.w[k] ^= mask & (r.t.w[k] ^ p.t.w[k]);
  }
}

// s may be secret (a key or a nonce): every entry of a row is read and
// the wanted one kept by mask.
ge base_mul(const uint8_t s[32]) {
  const BaseTable& tb = base_table();
  ge acc = ge_identity();
  for (int i = 0; i < 64; ++i) {
    uint64_t want = uint64_t(nibble(s, i));
    ge pick = tb.t[i][0];
    for (uint64_t j = 1; j < 16; ++j) {
      // (j ^ want) - 1 borrows out of bit 63 only when j == want
      ge_cmov(pick, tb.t[i][j], uint32_t(ct_mask(((j ^ want) - 1) >> 63)));
    }
    acc = ge_add(acc, pick);
  }
  return acc;
}

// [s]B - [k]A: a 4-bit window over k on -A, then the comb for [s]B.
ge double_scalar(const uint8_t k[32], const ge& a, const uint8_t s[32]) {
  ge neg = a;
  neg.x = fe_neg(a.x);
  neg.t = fe_neg(a.t);
  ge win[16];
  win[0] = ge_identity();
  win[1] = neg;
  for (int j = 2; j < 16; ++j) win[j] = ge_add(win[j - 1], neg);
  ge acc = ge_identity();
  for (int i = 63; i >= 0; --i) {
    for (int d = 0; d < 4; ++d) acc = ge_dbl(acc);
    acc = ge_add(acc, win[nibble(k, i)]);
  }
  return ge_add(acc, base_mul(s));
}

void expand(const uint8_t seed[32], uint8_t a[32], uint8_t prefix[32]) {
  uint8_t h[64];
  Sha512 sh;
  sh.update(seed, 32);
  sh.final(h);
  memcpy(a, h, 32);
  a[0] &= 248;
  a[31] &= 127;
  a[31] |= 64;
  memcpy(prefix, h + 32, 32);
}

}  // namespace

extern "C" {

void cbt_sha512(const uint8_t* msg, size_t n, uint8_t out[64]) {
  Sha512 sh;
  sh.update(msg, n);
  sh.final(out);
}

void cbt_ed25519_pubkey(const uint8_t seed[32], uint8_t pub[32]) {
  uint8_t a[32], prefix[32];
  expand(seed, a, prefix);
  encode(base_mul(a), pub);
}

// pub must be the seed's public key (cbt_ed25519_pubkey): the caller keeps
// it, so signing costs one fixed-base multiplication, not two.
void cbt_ed25519_sign(const uint8_t seed[32], const uint8_t pub[32],
                      const uint8_t* msg, size_t n, uint8_t sig[64]) {
  uint8_t a[32], prefix[32], d[64], r[32], k[32];
  expand(seed, a, prefix);
  Sha512 hr;
  hr.update(prefix, 32);
  hr.update(msg, n);
  hr.final(d);
  digest_mod_l(d, r);
  encode(base_mul(r), sig);
  Sha512 hk;
  hk.update(sig, 32);
  hk.update(pub, 32);
  hk.update(msg, n);
  hk.final(d);
  digest_mod_l(d, k);
  muladd(k, a, r, sig + 32);
}

// 1 when sig is a strict, cofactorless RFC 8032 signature of msg by pub.
int cbt_ed25519_verify(const uint8_t pub[32], const uint8_t* msg, size_t n,
                       const uint8_t sig[64]) {
  if (!scalar_lt_l(sig + 32)) return 0;
  ge a;
  if (!decode_strict(pub, &a)) return 0;
  uint8_t d[64], k[32], rr[32];
  Sha512 hk;
  hk.update(sig, 32);
  hk.update(pub, 32);
  hk.update(msg, n);
  hk.final(d);
  digest_mod_l(d, k);
  encode(double_scalar(k, a, sig + 32), rr);
  return memcmp(rr, sig, 32) == 0 ? 1 : 0;
}

}  // extern "C"
