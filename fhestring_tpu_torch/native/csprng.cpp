// AES-128-CTR cryptographically secure PRNG.
//
// TPU-native counterpart of the reference's `concrete-csprng` + `aes`
// native dependencies (SURVEY.md section 2.3): all client-side randomness
// (secret keys, encryption masks, noise sampling) is derived from an
// AES-128 counter stream.  Uses AES-NI when the build host supports it,
// with a portable software fallback.
//
// Exposed C ABI (used from Python via ctypes):
//   void aes128_ctr_fill(uint8_t* out, size_t n_bytes,
//                        const uint8_t key[16], uint64_t counter_base);

#include <cstdint>
#include <cstring>

#if defined(__AES__)
#include <wmmintrin.h>
#define HAVE_AESNI 1
#else
#define HAVE_AESNI 0
#endif

namespace {

// ---------------------------------------------------------------------------
// Portable software AES-128 (encryption only).
// ---------------------------------------------------------------------------

const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

inline uint8_t xtime(uint8_t x) {
  return static_cast<uint8_t>((x << 1) ^ ((x >> 7) * 0x1b));
}

struct SoftAes {
  uint8_t round_keys[11][16];

  explicit SoftAes(const uint8_t key[16]) {
    std::memcpy(round_keys[0], key, 16);
    uint8_t rcon = 1;
    for (int r = 1; r <= 10; ++r) {
      uint8_t* prev = round_keys[r - 1];
      uint8_t* cur = round_keys[r];
      uint8_t t[4] = {prev[12], prev[13], prev[14], prev[15]};
      uint8_t tmp = t[0];
      t[0] = static_cast<uint8_t>(SBOX[t[1]] ^ rcon);
      t[1] = SBOX[t[2]];
      t[2] = SBOX[t[3]];
      t[3] = SBOX[tmp];
      rcon = xtime(rcon);
      for (int i = 0; i < 4; ++i) cur[i] = prev[i] ^ t[i];
      for (int i = 4; i < 16; ++i) cur[i] = prev[i] ^ cur[i - 4];
    }
  }

  void encrypt_block(const uint8_t in[16], uint8_t out[16]) const {
    uint8_t s[16];
    for (int i = 0; i < 16; ++i) s[i] = in[i] ^ round_keys[0][i];
    for (int round = 1; round <= 10; ++round) {
      // SubBytes + ShiftRows
      uint8_t t[16];
      static const int SHIFT[16] = {0, 5, 10, 15, 4, 9, 14, 3,
                                    8, 13, 2, 7, 12, 1, 6, 11};
      for (int i = 0; i < 16; ++i) t[i] = SBOX[s[SHIFT[i]]];
      if (round < 10) {  // MixColumns
        for (int c = 0; c < 4; ++c) {
          uint8_t* col = t + 4 * c;
          uint8_t a0 = col[0], a1 = col[1], a2 = col[2], a3 = col[3];
          uint8_t all = static_cast<uint8_t>(a0 ^ a1 ^ a2 ^ a3);
          col[0] = static_cast<uint8_t>(a0 ^ all ^ xtime(static_cast<uint8_t>(a0 ^ a1)));
          col[1] = static_cast<uint8_t>(a1 ^ all ^ xtime(static_cast<uint8_t>(a1 ^ a2)));
          col[2] = static_cast<uint8_t>(a2 ^ all ^ xtime(static_cast<uint8_t>(a2 ^ a3)));
          col[3] = static_cast<uint8_t>(a3 ^ all ^ xtime(static_cast<uint8_t>(a3 ^ a0)));
        }
      }
      for (int i = 0; i < 16; ++i) s[i] = t[i] ^ round_keys[round][i];
    }
    std::memcpy(out, s, 16);
  }
};

#if HAVE_AESNI
struct HwAes {
  __m128i round_keys[11];

  static __m128i expand_step(__m128i key, __m128i keygened) {
    keygened = _mm_shuffle_epi32(keygened, _MM_SHUFFLE(3, 3, 3, 3));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    return _mm_xor_si128(key, keygened);
  }

  explicit HwAes(const uint8_t key[16]) {
    round_keys[0] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
#define EXPAND(i, rcon) \
  round_keys[i] = expand_step(round_keys[i - 1], \
      _mm_aeskeygenassist_si128(round_keys[i - 1], rcon))
    EXPAND(1, 0x01); EXPAND(2, 0x02); EXPAND(3, 0x04); EXPAND(4, 0x08);
    EXPAND(5, 0x10); EXPAND(6, 0x20); EXPAND(7, 0x40); EXPAND(8, 0x80);
    EXPAND(9, 0x1b); EXPAND(10, 0x36);
#undef EXPAND
  }

  void encrypt_block(const uint8_t in[16], uint8_t out[16]) const {
    __m128i m = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in));
    m = _mm_xor_si128(m, round_keys[0]);
    for (int r = 1; r < 10; ++r) m = _mm_aesenc_si128(m, round_keys[r]);
    m = _mm_aesenclast_si128(m, round_keys[10]);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out), m);
  }
};
#endif

}  // namespace

extern "C" {

void aes128_ctr_fill(uint8_t* out, size_t n_bytes, const uint8_t key[16],
                     uint64_t counter_base) {
#if HAVE_AESNI
  HwAes aes(key);
#else
  SoftAes aes(key);
#endif
  uint8_t block[16];
  uint8_t ctr[16] = {0};
  size_t produced = 0;
  uint64_t counter = counter_base;
  while (produced < n_bytes) {
    std::memcpy(ctr, &counter, 8);  // little-endian counter in low 8 bytes
    aes.encrypt_block(ctr, block);
    size_t take = n_bytes - produced < 16 ? n_bytes - produced : 16;
    std::memcpy(out + produced, block, take);
    produced += take;
    ++counter;
  }
}

int csprng_has_aesni(void) { return HAVE_AESNI; }

}  // extern "C"
