// Native host runtime: BLAKE2b keyed XOF + uniform RNS sampling.
//
// The port's copy of lattigo_tpu/native/xof.cpp (the JAX package's native
// XOF), with this header and the endianness note rewritten for the port and
// the key block hashed once per call instead of once per block.
// It implements the deterministic counter-mode byte stream behind
// lattigo_tpu_torch.ring.sampling.KeyedPRNG (the analog of the reference's
// blake2b XOF PRNG, ref utils/sampling/prng.go:35 — written from the RFC
// 7693 specification, not translated from any library).
//
// Block i of the stream is blake2b-512(key=key, data=LE64(counter_i)),
// exactly matching Python's hashlib.blake2b keyed mode, so this path and
// KeyedPRNG.read_u64_plain (the plain version the tests hold it against)
// are bit-identical.
//
// The hot consumers are host-side: common-reference-string expansion for
// the multiparty layer and seeded (compressed) evaluation-key expansion,
// both of which fill L x N uint64 polynomials (megabytes per key at
// production sizes). The Python loop pays ~1 us per 8 words in
// interpreter overhead; this path runs at memory speed.
//
// Build: g++ -O3 -shared -fPIC (lattigo_tpu_torch/build.py, at first use).

#include <cstdint>
#include <cstring>

// The stream/key memcpy paths assume little-endian word layout; a
// big-endian build would silently diverge from the hashlib stream
// despite the bit-identical contract, so refuse to compile there (the
// build, and with it KeyedPRNG, then raises).
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "native XOF requires a little-endian host");

typedef unsigned __int128 u128;

namespace {

const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

inline void G(uint64_t* v, int a, int b, int c, int d, uint64_t x,
              uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

// One compression: h (8 words), block m (16 LE words), byte counter t,
// final flag f.
void compress(uint64_t* h, const uint64_t* m, u128 t, bool f) {
  uint64_t v[16];
  std::memcpy(v, h, 64);
  std::memcpy(v + 8, IV, 64);
  v[12] ^= (uint64_t)t;
  v[13] ^= (uint64_t)(t >> 64);
  if (f) v[14] = ~v[14];
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = SIGMA[r];
    G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

// The chaining state after the key block, and the bytes hashed so far:
// the same for every block of a stream, so each call computes it once.
struct KeyState {
  uint64_t h[8];
  uint64_t t;
};

// klen <= 64, as enforced by the Python caller (key[:64]).
KeyState key_state(const uint8_t* key, int klen) {
  KeyState ks;
  std::memcpy(ks.h, IV, 64);
  // param word 0: digest_length=64 | key_length<<8 | fanout=1<<16 |
  // depth=1<<24 (RFC 7693 / BLAKE2 spec appendix A)
  ks.h[0] ^= 0x01010000ULL ^ ((uint64_t)klen << 8) ^ 64ULL;
  ks.t = 0;
  if (klen > 0) {
    // keyed mode: key padded to a full 128-byte block, hashed first
    uint64_t m[16];
    std::memset(m, 0, 128);
    std::memcpy(m, key, klen);
    compress(ks.h, m, 128, false);
    ks.t = 128;
  }
  return ks;
}

// blake2b-512(key, data=LE64(counter)) -> out8 (8 u64 words): the data
// block, 8 bytes of counter, is the final one.
void block_hash(const KeyState& ks, uint64_t counter, uint64_t* out8) {
  uint64_t h[8];
  std::memcpy(h, ks.h, 64);
  uint64_t m[16];
  std::memset(m, 0, 128);
  m[0] = counter;
  compress(h, m, ks.t + 8, true);
  std::memcpy(out8, h, 64);
}

}  // namespace

extern "C" {

// Fill out[0..count) with the KeyedPRNG stream starting at block
// `counter`: block i contributes 8 LE u64 words. Returns the next counter.
uint64_t xof_fill_u64(const uint8_t* key, int klen, uint64_t counter,
                      uint64_t* out, uint64_t count) {
  const KeyState ks = key_state(key, klen);
  uint64_t buf[8];
  uint64_t i = 0;
  while (i < count) {
    block_hash(ks, counter++, buf);
    uint64_t take = count - i < 8 ? count - i : 8;
    std::memcpy(out + i, buf, take * 8);
    i += take;
  }
  return counter;
}

// Uniform residues mod q: out[j] = (hi_j * 2^64 + lo_j) mod q where
// (hi, lo) are consecutive stream words — identical to
// KeyedPRNG.uniform_poly's per-limb reduction (bias < 2^-67).
// Consumes exactly 2*n words; returns the next counter. Requires 8 | n
// (polynomial lengths are powers of two >= 8), so hi and lo rows read
// whole blocks and match the Python path's two read_u64(n) calls.
uint64_t xof_uniform_mod_q(const uint8_t* key, int klen, uint64_t counter,
                           uint64_t q, uint64_t* out, uint64_t n) {
  // Python path: hi = read_u64(n); lo = read_u64(n)  (two passes)
  const KeyState ks = key_state(key, klen);
  uint64_t buf[8];
  for (uint64_t i = 0; i < n; i += 8) {
    block_hash(ks, counter++, buf);
    uint64_t take = n - i < 8 ? n - i : 8;
    std::memcpy(out + i, buf, take * 8);
  }
  for (uint64_t i = 0; i < n; i += 8) {
    block_hash(ks, counter++, buf);
    uint64_t take = n - i < 8 ? n - i : 8;
    for (uint64_t j = 0; j < take; j++) {
      u128 v = ((u128)(out[i + j] % q) << 64) | buf[j];
      out[i + j] = (uint64_t)(v % q);
    }
  }
  return counter;
}

}  // extern "C"
