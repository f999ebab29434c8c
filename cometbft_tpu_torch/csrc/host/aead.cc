// ChaCha20-Poly1305 AEAD (RFC 8439) for the p2p SecretConnection, host
// code built by g++ (ops/_build.host_lib) into build/cometbft_tpu_torch/.
//
// It replaces the `cryptography` wheel's ChaCha20Poly1305, which the
// JAX package's SecretConnection (cometbft_tpu/p2p/conn.py) uses and
// which the card's machine does not have. It is on the data path of
// every p2p message, so it is native code: a frame of 1 KB sealed or
// opened in pure Python would cost ~1 ms, a 2.5 MB catch-up seconds.
//
// The frame functions do what conn.py's _write_frames/_read_message do
// per chunk, for all chunks of one message in one call (ctypes releases
// the interpreter lock for it):
//   frame = u32le len | AEAD(key, nonce, more-flag | chunk <= 1024 B)
//   nonce = 96-bit little-endian counter, one per direction, +1 a frame
// Byte for byte what the reference writes and reads.
//
// C ABI for ctypes. No allocation: the caller passes the buffers.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr size_t DATA_MAX = 1024;                 // conn.py DATA_MAX_SIZE
constexpr size_t TAG = 16;
constexpr size_t FRAME_MAX = 4 + 1 + DATA_MAX + TAG;
constexpr uint64_t M44 = 0xfffffffffffULL;
constexpr uint64_t M42 = 0x3ffffffffffULL;
typedef unsigned __int128 u128;

inline uint32_t ld32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}
inline uint64_t ld64(const uint8_t* p) {
  return uint64_t(ld32(p)) | uint64_t(ld32(p + 4)) << 32;
}
inline void st32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}
inline void st64(uint8_t* p, uint64_t v) {
  st32(p, uint32_t(v)); st32(p + 4, uint32_t(v >> 32));
}
inline uint32_t rotl(uint32_t v, int c) { return (v << c) | (v >> (32 - c)); }

#define QR(a, b, c, d)                                      \
  a += b; d ^= a; d = rotl(d, 16); c += d; b ^= c; b = rotl(b, 12); \
  a += b; d ^= a; d = rotl(d, 8);  c += d; b ^= c; b = rotl(b, 7);

// One 64-byte ChaCha20 block (RFC 8439 §2.3).
void chacha_block(const uint8_t key[32], uint32_t counter,
                  const uint8_t nonce[12], uint8_t out[64]) {
  uint32_t s[16] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574};
  for (int i = 0; i < 8; ++i) s[4 + i] = ld32(key + 4 * i);
  s[12] = counter;
  for (int i = 0; i < 3; ++i) s[13 + i] = ld32(nonce + 4 * i);
  uint32_t x[16];
  memcpy(x, s, sizeof x);
  for (int i = 0; i < 10; ++i) {
    QR(x[0], x[4], x[8], x[12]) QR(x[1], x[5], x[9], x[13])
    QR(x[2], x[6], x[10], x[14]) QR(x[3], x[7], x[11], x[15])
    QR(x[0], x[5], x[10], x[15]) QR(x[1], x[6], x[11], x[12])
    QR(x[2], x[7], x[8], x[13]) QR(x[3], x[4], x[9], x[14])
  }
  for (int i = 0; i < 16; ++i) st32(out + 4 * i, x[i] + s[i]);
}

// ChaCha20 encryption from block counter 1 (RFC 8439 §2.4, §2.8).
void chacha_xor(const uint8_t key[32], const uint8_t nonce[12],
                const uint8_t* in, size_t n, uint8_t* out) {
  uint8_t ks[64];
  for (uint32_t ctr = 1; n > 0; ++ctr) {
    chacha_block(key, ctr, nonce, ks);
    size_t m = n < 64 ? n : 64;
    for (size_t i = 0; i < m; ++i) out[i] = in[i] ^ ks[i];
    in += m; out += m; n -= m;
  }
}

// Poly1305 (RFC 8439 §2.5), three 44/44/42-bit limbs, 128-bit products.
struct Poly {
  uint64_t r0, r1, r2, h0 = 0, h1 = 0, h2 = 0, pad0, pad1;

  explicit Poly(const uint8_t key[32]) {
    uint64_t t0 = ld64(key), t1 = ld64(key + 8);
    r0 = t0 & 0xffc0fffffffULL;
    r1 = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
    r2 = (t1 >> 24) & 0x00ffffffc0fULL;
    pad0 = ld64(key + 16);
    pad1 = ld64(key + 24);
  }

  void block(const uint8_t* m, uint64_t hibit) {
    const uint64_t s1 = r1 * 20, s2 = r2 * 20;
    uint64_t t0 = ld64(m), t1 = ld64(m + 8);
    h0 += t0 & M44;
    h1 += ((t0 >> 44) | (t1 << 20)) & M44;
    h2 += ((t1 >> 24) & M42) | hibit;
    u128 d0 = (u128)h0 * r0 + (u128)h1 * s2 + (u128)h2 * s1;
    u128 d1 = (u128)h0 * r1 + (u128)h1 * r0 + (u128)h2 * s2;
    u128 d2 = (u128)h0 * r2 + (u128)h1 * r1 + (u128)h2 * r0;
    uint64_t c = uint64_t(d0 >> 44); h0 = uint64_t(d0) & M44;
    d1 += c; c = uint64_t(d1 >> 44); h1 = uint64_t(d1) & M44;
    d2 += c; c = uint64_t(d2 >> 42); h2 = uint64_t(d2) & M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c;
  }

  // Absorb bytes, zero-padded to a 16-byte boundary at the end of the
  // piece (the AEAD pads each of aad and ciphertext; §2.8).
  void padded(const uint8_t* m, size_t n) {
    for (; n >= 16; m += 16, n -= 16) block(m, 1ULL << 40);
    if (n) {
      uint8_t b[16] = {0};
      memcpy(b, m, n);
      block(b, 1ULL << 40);
    }
  }

  void finish(uint8_t mac[16]) {
    uint64_t c;
    c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c; c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c;
    uint64_t g0 = h0 + 5; c = g0 >> 44; g0 &= M44;
    uint64_t g1 = h1 + c; c = g1 >> 44; g1 &= M44;
    uint64_t g2 = h2 + c - (1ULL << 42);
    c = (g2 >> 63) - 1;          // all ones when h >= p
    g0 &= c; g1 &= c; g2 &= c;
    c = ~c;
    h0 = (h0 & c) | g0; h1 = (h1 & c) | g1; h2 = (h2 & c) | g2;
    h0 += pad0 & M44; c = h0 >> 44; h0 &= M44;
    h1 += (((pad0 >> 44) | (pad1 << 20)) & M44) + c; c = h1 >> 44;
    h1 &= M44;
    h2 += ((pad1 >> 24) & M42) + c; h2 &= M42;
    st64(mac, h0 | (h1 << 44));
    st64(mac + 8, (h1 >> 20) | (h2 << 24));
  }
};

void tag_of(const uint8_t key[32], const uint8_t nonce[12],
            const uint8_t* aad, size_t alen, const uint8_t* ct, size_t clen,
            uint8_t tag[16]) {
  uint8_t otk[64];
  chacha_block(key, 0, nonce, otk);
  Poly p(otk);
  p.padded(aad, alen);
  p.padded(ct, clen);
  uint8_t lens[16];
  st64(lens, alen);
  st64(lens + 8, clen);
  p.block(lens, 1ULL << 40);
  p.finish(tag);
}

void aead_seal(const uint8_t key[32], const uint8_t nonce[12],
               const uint8_t* aad, size_t alen, const uint8_t* pt, size_t n,
               uint8_t* out) {
  chacha_xor(key, nonce, pt, n, out);
  tag_of(key, nonce, aad, alen, out, n, out + n);
}

bool aead_open(const uint8_t key[32], const uint8_t nonce[12],
               const uint8_t* aad, size_t alen, const uint8_t* ct, size_t n,
               uint8_t* out) {
  uint8_t tag[16];
  tag_of(key, nonce, aad, alen, ct, n, tag);
  uint8_t diff = 0;
  for (int i = 0; i < 16; ++i) diff |= tag[i] ^ ct[n + i];
  if (diff) return false;
  chacha_xor(key, nonce, ct, n, out);
  return true;
}

void counter_nonce(uint64_t counter, uint8_t nonce[12]) {
  st64(nonce, counter);
  st32(nonce + 8, 0);
}

}  // namespace

extern "C" {

// One AEAD seal: out gets n + 16 bytes (ciphertext | tag).
void cbt_aead_seal(const uint8_t* key, const uint8_t* nonce,
                   const uint8_t* aad, size_t alen, const uint8_t* pt,
                   size_t n, uint8_t* out) {
  aead_seal(key, nonce, aad, alen, pt, n, out);
}

// One AEAD open of n + 16 bytes: 0 and n bytes of out, or -1 (bad tag).
int cbt_aead_open(const uint8_t* key, const uint8_t* nonce,
                  const uint8_t* aad, size_t alen, const uint8_t* ct,
                  size_t n, uint8_t* out) {
  return aead_open(key, nonce, aad, alen, ct, n, out) ? 0 : -1;
}

// Seals one message as frames of <= 1024-byte chunks (an empty message
// is one empty chunk), nonces counter, counter + 1, ...; out needs
// cbt_aead_frames_max(len) bytes. Returns the number of frames; *out_len
// gets the bytes written.
uint64_t cbt_aead_seal_frames(const uint8_t* key, uint64_t counter,
                              const uint8_t* data, size_t len, uint8_t* out,
                              size_t* out_len) {
  uint64_t frames = len ? (len + DATA_MAX - 1) / DATA_MAX : 1;
  uint8_t pt[1 + DATA_MAX], nonce[12];
  uint8_t* o = out;
  for (uint64_t i = 0; i < frames; ++i) {
    size_t off = size_t(i) * DATA_MAX;
    size_t m = len - off < DATA_MAX ? len - off : DATA_MAX;
    pt[0] = i + 1 < frames ? 1 : 0;
    memcpy(pt + 1, data + off, m);
    counter_nonce(counter + i, nonce);
    st32(o, uint32_t(1 + m + TAG));
    aead_seal(key, nonce, nullptr, 0, pt, 1 + m, o + 4);
    o += 4 + 1 + m + TAG;
  }
  *out_len = size_t(o - out);
  return frames;
}

size_t cbt_aead_frames_max(size_t len) {
  return (len ? (len + DATA_MAX - 1) / DATA_MAX : 1) * FRAME_MAX;
}

// Opens the complete frames at the head of buf[0, len) in order, from
// nonce counter, until one whose more-flag is 0 (*done = 1) or until no
// complete frame is left (*done = 0). Chunks are appended to out (room
// for len bytes suffices). *consumed, *out_len and *frames say how far
// it got. Returns 0; -1 on a bad tag or a frame too short to hold the
// flag; -2 on a frame longer than DATA_MAX + 17, whose length goes to
// *bad_len (conn.py's oversized-frame check).
int cbt_aead_open_frames(const uint8_t* key, uint64_t counter,
                         const uint8_t* buf, size_t len, uint8_t* out,
                         size_t* consumed, size_t* out_len,
                         uint64_t* frames, int* done, uint32_t* bad_len) {
  size_t pos = 0, o = 0;
  uint64_t k = 0;
  uint8_t pt[DATA_MAX + 1 + TAG], nonce[12];
  int rc = 0;
  *done = 0;
  while (len - pos >= 4) {
    uint32_t ln = ld32(buf + pos);
    if (ln > DATA_MAX + 17) {
      *bad_len = ln;
      rc = -2;
      break;
    }
    if (len - pos - 4 < ln) break;
    if (ln < 1 + TAG) { rc = -1; break; }
    counter_nonce(counter + k, nonce);
    if (!aead_open(key, nonce, nullptr, 0, buf + pos + 4, ln - TAG, pt)) {
      rc = -1;
      break;
    }
    memcpy(out + o, pt + 1, ln - TAG - 1);
    o += ln - TAG - 1;
    pos += 4 + ln;
    ++k;
    if (pt[0] == 0) { *done = 1; break; }
  }
  *consumed = pos;
  *out_len = o;
  *frames = k;
  return rc;
}

}  // extern "C"
