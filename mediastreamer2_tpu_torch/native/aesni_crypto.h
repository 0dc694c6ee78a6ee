// Hardware SRTP primitives: AES-NI counter mode, SHA-NI SHA-1 (for
// HMAC-SHA1), and PCLMUL GHASH (for AEAD-GCM).
//
// Why this exists: the edge's per-packet crypto through dlopen'd libcrypto
// EVP costs ~380-590 ns/packet per direction at SRTP's 80-100 byte packet
// sizes — almost all of it fixed per-call overhead, not cipher work
// (tools/edge_profile.py).  On the bench host every leg shares ONE core,
// so that overhead IS the srtp_e2e capacity gap vs cleartext.  These
// routines run the same algorithms with zero library calls per packet.
//
// Compile-time gated: the build uses -march=native on the machine that
// runs it (native/__init__.py _build_so), so __AES__/__SHA__/__PCLMUL__
// are defined exactly when the CPU has the instructions; the portable
// -O2 fallback build keeps the EVP path.  Correctness is pinned by the
// RFC 3711/6188/7714 KATs and the byte-exact native<->Python
// cross-validation in tests/test_srtp_edge.py / test_srtp_kat.py.
//
// Parity: the reference gets these primitives from libsrtp2's crypto
// backends (ms_srtp.cpp delegating to srtp_protect/srtp_unprotect); here
// they are first-class so the batched edge stays call-free per packet.
#pragma once

#if defined(__AES__) && defined(__SHA__) && defined(__PCLMUL__) && \
    defined(__SSSE3__) && defined(__SSE4_1__)
#define MS2_HW_CRYPTO 1

#include <immintrin.h>
#include <stdint.h>
#include <string.h>

namespace ms2hw {

// ---------------------------------------------------------------- AES-NI

struct AesKey {
  __m128i rk[15];
  int rounds = 0;  // 10 (AES-128) or 14 (AES-256)
};

static inline __m128i aes128_step_(__m128i key, __m128i gen) {
  gen = _mm_shuffle_epi32(gen, 0xFF);
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, gen);
}

static inline __m128i aes256_step2_(__m128i key, __m128i gen) {
  gen = _mm_shuffle_epi32(gen, 0xAA);
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, gen);
}

static inline void aes_expand(const uint8_t* key, int key_len, AesKey* k) {
  if (key_len == 16) {
    k->rounds = 10;
    __m128i* rk = k->rk;
    rk[0] = _mm_loadu_si128((const __m128i*)key);
    rk[1] = aes128_step_(rk[0], _mm_aeskeygenassist_si128(rk[0], 0x01));
    rk[2] = aes128_step_(rk[1], _mm_aeskeygenassist_si128(rk[1], 0x02));
    rk[3] = aes128_step_(rk[2], _mm_aeskeygenassist_si128(rk[2], 0x04));
    rk[4] = aes128_step_(rk[3], _mm_aeskeygenassist_si128(rk[3], 0x08));
    rk[5] = aes128_step_(rk[4], _mm_aeskeygenassist_si128(rk[4], 0x10));
    rk[6] = aes128_step_(rk[5], _mm_aeskeygenassist_si128(rk[5], 0x20));
    rk[7] = aes128_step_(rk[6], _mm_aeskeygenassist_si128(rk[6], 0x40));
    rk[8] = aes128_step_(rk[7], _mm_aeskeygenassist_si128(rk[7], 0x80));
    rk[9] = aes128_step_(rk[8], _mm_aeskeygenassist_si128(rk[8], 0x1b));
    rk[10] = aes128_step_(rk[9], _mm_aeskeygenassist_si128(rk[9], 0x36));
  } else {
    k->rounds = 14;
    __m128i* rk = k->rk;
    rk[0] = _mm_loadu_si128((const __m128i*)key);
    rk[1] = _mm_loadu_si128((const __m128i*)(key + 16));
    rk[2] = aes128_step_(rk[0], _mm_aeskeygenassist_si128(rk[1], 0x01));
    rk[3] = aes256_step2_(rk[1], _mm_aeskeygenassist_si128(rk[2], 0x00));
    rk[4] = aes128_step_(rk[2], _mm_aeskeygenassist_si128(rk[3], 0x02));
    rk[5] = aes256_step2_(rk[3], _mm_aeskeygenassist_si128(rk[4], 0x00));
    rk[6] = aes128_step_(rk[4], _mm_aeskeygenassist_si128(rk[5], 0x04));
    rk[7] = aes256_step2_(rk[5], _mm_aeskeygenassist_si128(rk[6], 0x00));
    rk[8] = aes128_step_(rk[6], _mm_aeskeygenassist_si128(rk[7], 0x08));
    rk[9] = aes256_step2_(rk[7], _mm_aeskeygenassist_si128(rk[8], 0x00));
    rk[10] = aes128_step_(rk[8], _mm_aeskeygenassist_si128(rk[9], 0x10));
    rk[11] = aes256_step2_(rk[9], _mm_aeskeygenassist_si128(rk[10], 0x00));
    rk[12] = aes128_step_(rk[10], _mm_aeskeygenassist_si128(rk[11], 0x20));
    rk[13] = aes256_step2_(rk[11], _mm_aeskeygenassist_si128(rk[12], 0x00));
    rk[14] = aes128_step_(rk[12], _mm_aeskeygenassist_si128(rk[13], 0x40));
  }
}

static inline __m128i aes_enc_block(const AesKey& k, __m128i b) {
  b = _mm_xor_si128(b, k.rk[0]);
  for (int r = 1; r < k.rounds; r++) b = _mm_aesenc_si128(b, k.rk[r]);
  return _mm_aesenclast_si128(b, k.rk[k.rounds]);
}

// Encrypt `n` independent 16-byte blocks in -> out, 4-wide pipelined
// (aesenc latency ~4 cycles, throughput 1/cycle: independent blocks hide
// the latency).
static inline void aes_enc_blocks(const AesKey& k, const uint8_t* in,
                                  uint8_t* out, int n) {
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    __m128i b0 = _mm_loadu_si128((const __m128i*)(in + 16 * i));
    __m128i b1 = _mm_loadu_si128((const __m128i*)(in + 16 * i + 16));
    __m128i b2 = _mm_loadu_si128((const __m128i*)(in + 16 * i + 32));
    __m128i b3 = _mm_loadu_si128((const __m128i*)(in + 16 * i + 48));
    b0 = _mm_xor_si128(b0, k.rk[0]);
    b1 = _mm_xor_si128(b1, k.rk[0]);
    b2 = _mm_xor_si128(b2, k.rk[0]);
    b3 = _mm_xor_si128(b3, k.rk[0]);
    for (int r = 1; r < k.rounds; r++) {
      b0 = _mm_aesenc_si128(b0, k.rk[r]);
      b1 = _mm_aesenc_si128(b1, k.rk[r]);
      b2 = _mm_aesenc_si128(b2, k.rk[r]);
      b3 = _mm_aesenc_si128(b3, k.rk[r]);
    }
    b0 = _mm_aesenclast_si128(b0, k.rk[k.rounds]);
    b1 = _mm_aesenclast_si128(b1, k.rk[k.rounds]);
    b2 = _mm_aesenclast_si128(b2, k.rk[k.rounds]);
    b3 = _mm_aesenclast_si128(b3, k.rk[k.rounds]);
    _mm_storeu_si128((__m128i*)(out + 16 * i), b0);
    _mm_storeu_si128((__m128i*)(out + 16 * i + 16), b1);
    _mm_storeu_si128((__m128i*)(out + 16 * i + 32), b2);
    _mm_storeu_si128((__m128i*)(out + 16 * i + 48), b3);
  }
  for (; i < n; i++)
    _mm_storeu_si128(
        (__m128i*)(out + 16 * i),
        aes_enc_block(k, _mm_loadu_si128((const __m128i*)(in + 16 * i))));
}

// ------------------------------------------------------------- SHA-1 NI

struct Sha1State {
  uint32_t h[5];
};

static inline void sha1_init(Sha1State* s) {
  s->h[0] = 0x67452301;
  s->h[1] = 0xEFCDAB89;
  s->h[2] = 0x98BADCFE;
  s->h[3] = 0x10325476;
  s->h[4] = 0xC3D2E1F0;
}

// One 64-byte block with the SHA extensions (canonical x86 SHA-NI
// schedule: sha1rnds4 does 4 rounds, sha1msg1/msg2 run the W recurrence,
// sha1nexte folds rotl30 of the old E).
static inline void sha1_compress(Sha1State* st, const uint8_t* data) {
  uint32_t* state = st->h;
  const __m128i MASK =
      _mm_set_epi64x(0x0001020304050607ULL, 0x08090a0b0c0d0e0fULL);
  __m128i ABCD = _mm_loadu_si128((const __m128i*)state);
  __m128i E0 = _mm_set_epi32((int)state[4], 0, 0, 0);
  ABCD = _mm_shuffle_epi32(ABCD, 0x1B);
  __m128i ABCD_SAVE = ABCD, E0_SAVE = E0, E1;

  __m128i MSG0 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i*)(data + 0)), MASK);
  __m128i MSG1 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i*)(data + 16)), MASK);
  __m128i MSG2 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i*)(data + 32)), MASK);
  __m128i MSG3 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i*)(data + 48)), MASK);

  // Rounds 0-3
  E0 = _mm_add_epi32(E0, MSG0);
  E1 = ABCD;
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 0);
  // Rounds 4-7
  E1 = _mm_sha1nexte_epu32(E1, MSG1);
  E0 = ABCD;
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 0);
  MSG0 = _mm_sha1msg1_epu32(MSG0, MSG1);
  // Rounds 8-11
  E0 = _mm_sha1nexte_epu32(E0, MSG2);
  E1 = ABCD;
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 0);
  MSG1 = _mm_sha1msg1_epu32(MSG1, MSG2);
  MSG0 = _mm_xor_si128(MSG0, MSG2);
  // Rounds 12-15
  E1 = _mm_sha1nexte_epu32(E1, MSG3);
  E0 = ABCD;
  MSG0 = _mm_sha1msg2_epu32(MSG0, MSG3);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 0);
  MSG2 = _mm_sha1msg1_epu32(MSG2, MSG3);
  MSG1 = _mm_xor_si128(MSG1, MSG3);
  // Rounds 16-19
  E0 = _mm_sha1nexte_epu32(E0, MSG0);
  E1 = ABCD;
  MSG1 = _mm_sha1msg2_epu32(MSG1, MSG0);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 0);
  MSG3 = _mm_sha1msg1_epu32(MSG3, MSG0);
  MSG2 = _mm_xor_si128(MSG2, MSG0);
  // Rounds 20-23
  E1 = _mm_sha1nexte_epu32(E1, MSG1);
  E0 = ABCD;
  MSG2 = _mm_sha1msg2_epu32(MSG2, MSG1);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 1);
  MSG0 = _mm_sha1msg1_epu32(MSG0, MSG1);
  MSG3 = _mm_xor_si128(MSG3, MSG1);
  // Rounds 24-27
  E0 = _mm_sha1nexte_epu32(E0, MSG2);
  E1 = ABCD;
  MSG3 = _mm_sha1msg2_epu32(MSG3, MSG2);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 1);
  MSG1 = _mm_sha1msg1_epu32(MSG1, MSG2);
  MSG0 = _mm_xor_si128(MSG0, MSG2);
  // Rounds 28-31
  E1 = _mm_sha1nexte_epu32(E1, MSG3);
  E0 = ABCD;
  MSG0 = _mm_sha1msg2_epu32(MSG0, MSG3);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 1);
  MSG2 = _mm_sha1msg1_epu32(MSG2, MSG3);
  MSG1 = _mm_xor_si128(MSG1, MSG3);
  // Rounds 32-35
  E0 = _mm_sha1nexte_epu32(E0, MSG0);
  E1 = ABCD;
  MSG1 = _mm_sha1msg2_epu32(MSG1, MSG0);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 1);
  MSG3 = _mm_sha1msg1_epu32(MSG3, MSG0);
  MSG2 = _mm_xor_si128(MSG2, MSG0);
  // Rounds 36-39
  E1 = _mm_sha1nexte_epu32(E1, MSG1);
  E0 = ABCD;
  MSG2 = _mm_sha1msg2_epu32(MSG2, MSG1);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 1);
  MSG0 = _mm_sha1msg1_epu32(MSG0, MSG1);
  MSG3 = _mm_xor_si128(MSG3, MSG1);
  // Rounds 40-43
  E0 = _mm_sha1nexte_epu32(E0, MSG2);
  E1 = ABCD;
  MSG3 = _mm_sha1msg2_epu32(MSG3, MSG2);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 2);
  MSG1 = _mm_sha1msg1_epu32(MSG1, MSG2);
  MSG0 = _mm_xor_si128(MSG0, MSG2);
  // Rounds 44-47
  E1 = _mm_sha1nexte_epu32(E1, MSG3);
  E0 = ABCD;
  MSG0 = _mm_sha1msg2_epu32(MSG0, MSG3);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 2);
  MSG2 = _mm_sha1msg1_epu32(MSG2, MSG3);
  MSG1 = _mm_xor_si128(MSG1, MSG3);
  // Rounds 48-51
  E0 = _mm_sha1nexte_epu32(E0, MSG0);
  E1 = ABCD;
  MSG1 = _mm_sha1msg2_epu32(MSG1, MSG0);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 2);
  MSG3 = _mm_sha1msg1_epu32(MSG3, MSG0);
  MSG2 = _mm_xor_si128(MSG2, MSG0);
  // Rounds 52-55
  E1 = _mm_sha1nexte_epu32(E1, MSG1);
  E0 = ABCD;
  MSG2 = _mm_sha1msg2_epu32(MSG2, MSG1);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 2);
  MSG0 = _mm_sha1msg1_epu32(MSG0, MSG1);
  MSG3 = _mm_xor_si128(MSG3, MSG1);
  // Rounds 56-59
  E0 = _mm_sha1nexte_epu32(E0, MSG2);
  E1 = ABCD;
  MSG3 = _mm_sha1msg2_epu32(MSG3, MSG2);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 2);
  MSG1 = _mm_sha1msg1_epu32(MSG1, MSG2);
  MSG0 = _mm_xor_si128(MSG0, MSG2);
  // Rounds 60-63
  E1 = _mm_sha1nexte_epu32(E1, MSG3);
  E0 = ABCD;
  MSG0 = _mm_sha1msg2_epu32(MSG0, MSG3);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 3);
  MSG2 = _mm_sha1msg1_epu32(MSG2, MSG3);
  MSG1 = _mm_xor_si128(MSG1, MSG3);
  // Rounds 64-67
  E0 = _mm_sha1nexte_epu32(E0, MSG0);
  E1 = ABCD;
  MSG1 = _mm_sha1msg2_epu32(MSG1, MSG0);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 3);
  MSG3 = _mm_sha1msg1_epu32(MSG3, MSG0);
  MSG2 = _mm_xor_si128(MSG2, MSG0);
  // Rounds 68-71
  E1 = _mm_sha1nexte_epu32(E1, MSG1);
  E0 = ABCD;
  MSG2 = _mm_sha1msg2_epu32(MSG2, MSG1);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 3);
  MSG3 = _mm_xor_si128(MSG3, MSG1);
  // Rounds 72-75
  E0 = _mm_sha1nexte_epu32(E0, MSG2);
  E1 = ABCD;
  MSG3 = _mm_sha1msg2_epu32(MSG3, MSG2);
  ABCD = _mm_sha1rnds4_epu32(ABCD, E0, 3);
  // Rounds 76-79
  E1 = _mm_sha1nexte_epu32(E1, MSG3);
  E0 = ABCD;
  ABCD = _mm_sha1rnds4_epu32(ABCD, E1, 3);

  E0 = _mm_sha1nexte_epu32(E0, E0_SAVE);
  ABCD = _mm_add_epi32(ABCD, ABCD_SAVE);
  ABCD = _mm_shuffle_epi32(ABCD, 0x1B);
  _mm_storeu_si128((__m128i*)state, ABCD);
  state[4] = (uint32_t)_mm_extract_epi32(E0, 3);
}

// Two independent SHA-1 compressions, interleaved (2-buffer SHA).
// sha1rnds4 is a ~6-cycle-latency serial chain per block; a second
// INDEPENDENT chain fills the latency slots, so two blocks finish in
// ~1.2x the time of one.  Same math as sha1_compress (loop form of the
// identical schedule: e_in(g) = nexte(ABCD at start of group g-1, W_g)),
// verified bit-exact against the 1-buffer path by the SRTP KATs and
// test_srtp_edge's native<->Python cross-check.
static inline void sha1_compress_x2(Sha1State* s0, const uint8_t* d0,
                                    Sha1State* s1, const uint8_t* d1) {
  const __m128i MASK =
      _mm_set_epi64x(0x0001020304050607ULL, 0x08090a0b0c0d0e0fULL);
  Sha1State* s[2] = {s0, s1};
  const uint8_t* d[2] = {d0, d1};
  // Same rolling-register schedule as sha1_compress, every statement
  // doubled with explicit per-lane variables (token-pasted) so both
  // chains stay in registers: ~14 live xmm, saves may spill (cold).
  __m128i ABCD_0, ABCD_1, E0_0, E0_1, E1_0, E1_1;
  __m128i M0_0, M0_1, M1_0, M1_1, M2_0, M2_1, M3_0, M3_1;
  ABCD_0 = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i*)s[0]->h), 0x1B);
  ABCD_1 = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i*)s[1]->h), 0x1B);
  E0_0 = _mm_set_epi32((int)s[0]->h[4], 0, 0, 0);
  E0_1 = _mm_set_epi32((int)s[1]->h[4], 0, 0, 0);
  const __m128i AS_0 = ABCD_0, AS_1 = ABCD_1, ES_0 = E0_0, ES_1 = E0_1;
  M0_0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)d[0]), MASK);
  M0_1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)d[1]), MASK);
  M1_0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[0] + 16)), MASK);
  M1_1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[1] + 16)), MASK);
  M2_0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[0] + 32)), MASK);
  M2_1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[1] + 32)), MASK);
  M3_0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[0] + 48)), MASK);
  M3_1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(d[1] + 48)), MASK);
  // group 0: E0 carries H4 directly
  E0_0 = _mm_add_epi32(E0_0, M0_0);
  E0_1 = _mm_add_epi32(E0_1, M0_1);
  E1_0 = ABCD_0;
  E1_1 = ABCD_1;
  ABCD_0 = _mm_sha1rnds4_epu32(ABCD_0, E0_0, 0);
  ABCD_1 = _mm_sha1rnds4_epu32(ABCD_1, E0_1, 0);
// Middle group: Ein absorbs W; Eout saves pre-round ABCD; optional
// schedule updates (msg2 target, msg1 target, xor target) compile away
// when the flag literal is 0.  Lane-1 statements are interleaved after
// each lane-0 statement so the two serial chains overlap.
#define MS2_G2(Ein, Eout, W, do2, T2, rnd, do1, T1, dox, TX)              \
  Ein##_0 = _mm_sha1nexte_epu32(Ein##_0, W##_0);                          \
  Ein##_1 = _mm_sha1nexte_epu32(Ein##_1, W##_1);                          \
  Eout##_0 = ABCD_0;                                                      \
  Eout##_1 = ABCD_1;                                                      \
  if (do2) T2##_0 = _mm_sha1msg2_epu32(T2##_0, W##_0);                    \
  if (do2) T2##_1 = _mm_sha1msg2_epu32(T2##_1, W##_1);                    \
  ABCD_0 = _mm_sha1rnds4_epu32(ABCD_0, Ein##_0, (rnd));                   \
  ABCD_1 = _mm_sha1rnds4_epu32(ABCD_1, Ein##_1, (rnd));                   \
  if (do1) T1##_0 = _mm_sha1msg1_epu32(T1##_0, W##_0);                    \
  if (do1) T1##_1 = _mm_sha1msg1_epu32(T1##_1, W##_1);                    \
  if (dox) TX##_0 = _mm_xor_si128(TX##_0, W##_0);                         \
  if (dox) TX##_1 = _mm_xor_si128(TX##_1, W##_1);
  MS2_G2(E1, E0, M1, 0, M0, 0, 1, M0, 0, M0)   // g1
  MS2_G2(E0, E1, M2, 0, M0, 0, 1, M1, 1, M0)   // g2
  MS2_G2(E1, E0, M3, 1, M0, 0, 1, M2, 1, M1)   // g3
  MS2_G2(E0, E1, M0, 1, M1, 0, 1, M3, 1, M2)   // g4
  MS2_G2(E1, E0, M1, 1, M2, 1, 1, M0, 1, M3)   // g5
  MS2_G2(E0, E1, M2, 1, M3, 1, 1, M1, 1, M0)   // g6
  MS2_G2(E1, E0, M3, 1, M0, 1, 1, M2, 1, M1)   // g7
  MS2_G2(E0, E1, M0, 1, M1, 1, 1, M3, 1, M2)   // g8
  MS2_G2(E1, E0, M1, 1, M2, 1, 1, M0, 1, M3)   // g9
  MS2_G2(E0, E1, M2, 1, M3, 2, 1, M1, 1, M0)   // g10
  MS2_G2(E1, E0, M3, 1, M0, 2, 1, M2, 1, M1)   // g11
  MS2_G2(E0, E1, M0, 1, M1, 2, 1, M3, 1, M2)   // g12
  MS2_G2(E1, E0, M1, 1, M2, 2, 1, M0, 1, M3)   // g13
  MS2_G2(E0, E1, M2, 1, M3, 2, 1, M1, 1, M0)   // g14
  MS2_G2(E1, E0, M3, 1, M0, 3, 1, M2, 1, M1)   // g15
  MS2_G2(E0, E1, M0, 1, M1, 3, 1, M3, 1, M2)   // g16
  MS2_G2(E1, E0, M1, 1, M2, 3, 0, M0, 1, M3)   // g17
  MS2_G2(E0, E1, M2, 1, M3, 3, 0, M0, 0, M0)   // g18
  MS2_G2(E1, E0, M3, 0, M0, 3, 0, M0, 0, M0)   // g19
#undef MS2_G2
  E0_0 = _mm_sha1nexte_epu32(E0_0, ES_0);
  E0_1 = _mm_sha1nexte_epu32(E0_1, ES_1);
  ABCD_0 = _mm_shuffle_epi32(_mm_add_epi32(ABCD_0, AS_0), 0x1B);
  ABCD_1 = _mm_shuffle_epi32(_mm_add_epi32(ABCD_1, AS_1), 0x1B);
  _mm_storeu_si128((__m128i*)s[0]->h, ABCD_0);
  _mm_storeu_si128((__m128i*)s[1]->h, ABCD_1);
  s[0]->h[4] = (uint32_t)_mm_extract_epi32(E0_0, 3);
  s[1]->h[4] = (uint32_t)_mm_extract_epi32(E0_1, 3);
}

// Finish a SHA-1 whose first `prefix_bytes` were already compressed into
// `st` (HMAC midstate), over data1||data2.  data1 may be any length
// (whole blocks are compressed in place, no copy); data2 must be small
// (<= 20 bytes: the ROC suffix or the inner digest).
static inline void sha1_tail(Sha1State st, uint64_t prefix_bytes,
                             const uint8_t* d1, int l1, const uint8_t* d2,
                             int l2, uint8_t out[20]) {
  uint64_t total_bits = (prefix_bytes + uint64_t(l1) + uint64_t(l2)) * 8;
  int full = l1 & ~63;
  for (int off = 0; off < full; off += 64) sha1_compress(&st, d1 + off);
  // remainder (<64) + d2 (<=20) + 0x80 + pad + 8-byte length <= 192
  uint8_t buf[192];
  int len = l1 - full;
  memcpy(buf, d1 + full, size_t(len));
  if (l2) {
    memcpy(buf + len, d2, size_t(l2));
    len += l2;
  }
  buf[len++] = 0x80;
  while (len % 64 != 56) buf[len++] = 0;
  for (int i = 0; i < 8; i++)
    buf[len++] = uint8_t(total_bits >> (56 - 8 * i));
  for (int off = 0; off < len; off += 64) sha1_compress(&st, buf + off);
  for (int i = 0; i < 5; i++) {
    out[4 * i] = uint8_t(st.h[i] >> 24);
    out[4 * i + 1] = uint8_t(st.h[i] >> 16);
    out[4 * i + 2] = uint8_t(st.h[i] >> 8);
    out[4 * i + 3] = uint8_t(st.h[i]);
  }
}

// HMAC-SHA1 from precomputed ipad/opad midstates over data||roc(4B BE).
static inline void hmac_sha1_tag(const Sha1State& inner,
                                 const Sha1State& outer, const uint8_t* data,
                                 int len, uint32_t roc, uint8_t digest[20]) {
  uint8_t rocb[4] = {uint8_t(roc >> 24), uint8_t(roc >> 16),
                     uint8_t(roc >> 8), uint8_t(roc)};
  uint8_t ihash[20];
  sha1_tail(inner, 64, data, len, rocb, 4, ihash);
  sha1_tail(outer, 64, ihash, 20, nullptr, 0, digest);
}

// Pairwise HMAC-SHA1 over two EQUAL-LENGTH messages (the batched-edge
// case: every SRTP packet in a tick shares one wire size), each message
// data||roc(4B BE), lanes on independent midstates/keys.  Identical
// block structure lets every compress run through the interleaved
// 2-buffer kernel: ~1.6x the per-packet MAC throughput.
static inline void hmac_sha1_tag_x2(const Sha1State& in0,
                                    const Sha1State& out0, const uint8_t* d0,
                                    uint32_t roc0, const Sha1State& in1,
                                    const Sha1State& out1, const uint8_t* d1,
                                    uint32_t roc1, int len, uint8_t dig0[20],
                                    uint8_t dig1[20]) {
  Sha1State a = in0, b = in1;
  uint64_t total_bits = (64 + uint64_t(len) + 4) * 8;
  int full = len & ~63;
  for (int off = 0; off < full; off += 64)
    sha1_compress_x2(&a, d0 + off, &b, d1 + off);
  // tail: remainder + roc(4) + 0x80 + pad + length — same layout both lanes
  uint8_t bufa[192], bufb[192];
  int n = len - full;
  memcpy(bufa, d0 + full, size_t(n));
  memcpy(bufb, d1 + full, size_t(n));
  for (int i = 0; i < 4; i++) {
    bufa[n + i] = uint8_t(roc0 >> (24 - 8 * i));
    bufb[n + i] = uint8_t(roc1 >> (24 - 8 * i));
  }
  n += 4;
  bufa[n] = bufb[n] = 0x80;
  n++;
  while (n % 64 != 56) bufa[n] = bufb[n] = 0, n++;
  for (int i = 0; i < 8; i++)
    bufa[n + i] = bufb[n + i] = uint8_t(total_bits >> (56 - 8 * i));
  n += 8;
  for (int off = 0; off < n; off += 64)
    sha1_compress_x2(&a, bufa + off, &b, bufb + off);
  uint8_t ia[20], ib[20];
  for (int i = 0; i < 5; i++)
    for (int j = 0; j < 4; j++) {
      ia[4 * i + j] = uint8_t(a.h[i] >> (24 - 8 * j));
      ib[4 * i + j] = uint8_t(b.h[i] >> (24 - 8 * j));
    }
  // outer: one 64-byte block each (20-byte digest + pad), interleaved
  memset(bufa, 0, 64);
  memset(bufb, 0, 64);
  memcpy(bufa, ia, 20);
  memcpy(bufb, ib, 20);
  bufa[20] = bufb[20] = 0x80;
  uint64_t obits = (64 + 20) * 8;
  for (int i = 0; i < 8; i++)
    bufa[56 + i] = bufb[56 + i] = uint8_t(obits >> (56 - 8 * i));
  a = out0;
  b = out1;
  sha1_compress_x2(&a, bufa, &b, bufb);
  for (int i = 0; i < 5; i++)
    for (int j = 0; j < 4; j++) {
      dig0[4 * i + j] = uint8_t(a.h[i] >> (24 - 8 * j));
      dig1[4 * i + j] = uint8_t(b.h[i] >> (24 - 8 * j));
    }
}

static inline void hmac_midstates(const uint8_t* k_a, int ka_len,
                                  Sha1State* inner, Sha1State* outer) {
  uint8_t pad[64];
  for (int i = 0; i < 64; i++) pad[i] = (i < ka_len ? k_a[i] : 0) ^ 0x36;
  sha1_init(inner);
  sha1_compress(inner, pad);
  for (int i = 0; i < 64; i++) pad[i] = (i < ka_len ? k_a[i] : 0) ^ 0x5c;
  sha1_init(outer);
  sha1_compress(outer, pad);
}

// --------------------------------------------------------- GHASH / GCM

// Carry-less 128-bit multiply WITHOUT reduction: 256-bit product of the
// byte-reflected operands as (hi, lo), XOR-accumulation-safe.  Splitting
// multiply from reduction lets the 4-block aggregated GHASH below run ONE
// reduction per four blocks (reduction is linear, so reducing the XOR of
// four raw products equals XORing four reduced products).
static inline void gfmul_nr(__m128i a, __m128i b, __m128i* hi, __m128i* lo) {
  __m128i t0 = _mm_clmulepi64_si128(a, b, 0x00);
  __m128i t1 = _mm_clmulepi64_si128(a, b, 0x10);
  __m128i t2 = _mm_clmulepi64_si128(a, b, 0x01);
  __m128i t3 = _mm_clmulepi64_si128(a, b, 0x11);
  t1 = _mm_xor_si128(t1, t2);
  *lo = _mm_xor_si128(t0, _mm_slli_si128(t1, 8));
  *hi = _mm_xor_si128(t3, _mm_srli_si128(t1, 8));
}

// Bit-shift fixup (reflected-domain <<1 across 256 bits) + polynomial
// reduction of a raw product (hi, lo) back to 128 bits.
static inline __m128i gf_reduce(__m128i tmp6, __m128i tmp3) {
  __m128i tmp7 = _mm_srli_epi32(tmp3, 31);
  __m128i tmp8 = _mm_srli_epi32(tmp6, 31);
  tmp3 = _mm_slli_epi32(tmp3, 1);
  tmp6 = _mm_slli_epi32(tmp6, 1);
  __m128i tmp9 = _mm_srli_si128(tmp7, 12);
  tmp8 = _mm_slli_si128(tmp8, 4);
  tmp7 = _mm_slli_si128(tmp7, 4);
  tmp3 = _mm_or_si128(tmp3, tmp7);
  tmp6 = _mm_or_si128(tmp6, tmp8);
  tmp6 = _mm_or_si128(tmp6, tmp9);
  tmp7 = _mm_slli_epi32(tmp3, 31);
  tmp8 = _mm_slli_epi32(tmp3, 30);
  tmp9 = _mm_slli_epi32(tmp3, 25);
  tmp7 = _mm_xor_si128(tmp7, tmp8);
  tmp7 = _mm_xor_si128(tmp7, tmp9);
  tmp8 = _mm_srli_si128(tmp7, 4);
  tmp7 = _mm_slli_si128(tmp7, 12);
  tmp3 = _mm_xor_si128(tmp3, tmp7);
  __m128i tmp2 = _mm_srli_epi32(tmp3, 1);
  __m128i tmp4 = _mm_srli_epi32(tmp3, 2);
  __m128i tmp5 = _mm_srli_epi32(tmp3, 7);
  tmp2 = _mm_xor_si128(tmp2, tmp4);
  tmp2 = _mm_xor_si128(tmp2, tmp5);
  tmp2 = _mm_xor_si128(tmp2, tmp8);
  tmp3 = _mm_xor_si128(tmp3, tmp2);
  return _mm_xor_si128(tmp6, tmp3);
}

// Carry-less 128-bit GF multiply with the GCM reduction (operands in
// byte-reflected form, i.e. loaded then shuffled with BSWAP_MASK).
static inline __m128i gfmul(__m128i a, __m128i b) {
  __m128i hi, lo;
  gfmul_nr(a, b, &hi, &lo);
  return gf_reduce(hi, lo);
}

static inline __m128i bswap16_(__m128i x) {
  const __m128i M = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                 13, 14, 15);
  return _mm_shuffle_epi8(x, M);
}

struct GhashKey {
  // H^1..H^4 (byte-reflected) for 4-block aggregated absorption
  __m128i h, h2, h3, h4;
};

// GHASH absorb of `len` bytes (zero-padded to a block), updating Y.
// Aggregated 4 blocks at a time: Y' = (Y^X1)*H^4 ^ X2*H^3 ^ X3*H^2 ^ X4*H
// with ONE reduction — the four CLMUL groups are independent (ILP) and
// the serial reduce chain runs once per 64 bytes instead of per 16.
// Values are identical to the per-block form (reduction is linear).
static inline __m128i ghash_update(__m128i y, const GhashKey& k,
                                   const uint8_t* p, int len) {
  int i = 0;
  for (; i + 64 <= len; i += 64) {
    __m128i x1 = bswap16_(_mm_loadu_si128((const __m128i*)(p + i)));
    __m128i x2 = bswap16_(_mm_loadu_si128((const __m128i*)(p + i + 16)));
    __m128i x3 = bswap16_(_mm_loadu_si128((const __m128i*)(p + i + 32)));
    __m128i x4 = bswap16_(_mm_loadu_si128((const __m128i*)(p + i + 48)));
    __m128i hi, lo, hi2, lo2;
    gfmul_nr(_mm_xor_si128(y, x1), k.h4, &hi, &lo);
    gfmul_nr(x2, k.h3, &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2);
    lo = _mm_xor_si128(lo, lo2);
    gfmul_nr(x3, k.h2, &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2);
    lo = _mm_xor_si128(lo, lo2);
    gfmul_nr(x4, k.h, &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2);
    lo = _mm_xor_si128(lo, lo2);
    y = gf_reduce(hi, lo);
  }
  for (; i + 16 <= len; i += 16) {
    __m128i x = bswap16_(_mm_loadu_si128((const __m128i*)(p + i)));
    y = gfmul(_mm_xor_si128(y, x), k.h);
  }
  if (i < len) {
    uint8_t last[16] = {0};
    memcpy(last, p + i, size_t(len - i));
    __m128i x = bswap16_(_mm_loadu_si128((const __m128i*)last));
    y = gfmul(_mm_xor_si128(y, x), k.h);
  }
  return y;
}

struct GcmKey {
  AesKey aes;
  GhashKey h;  // GHASH key E_K(0^128) and its powers, byte-reflected
};

static inline void gcm_expand(const uint8_t* key, int key_len, GcmKey* g) {
  aes_expand(key, key_len, &g->aes);
  __m128i zero = _mm_setzero_si128();
  g->h.h = bswap16_(aes_enc_block(g->aes, zero));
  g->h.h2 = gfmul(g->h.h, g->h.h);
  g->h.h3 = gfmul(g->h.h2, g->h.h);
  g->h.h4 = gfmul(g->h.h3, g->h.h);
}

// AES-GCM with a 12-byte IV: in -> out (len bytes), header as AAD, tag out.
// encrypt=true: out=ciphertext, tag computed.  encrypt=false: in is
// ciphertext, out=plaintext, tag computed over the INPUT — caller compares.
// in==out (in-place) is safe in BOTH directions: the GHASH over the
// ciphertext runs before the decrypt XOR can overwrite it.
static inline void gcm_crypt(const GcmKey& g, const uint8_t iv[12],
                             const uint8_t* aad, int aad_len,
                             const uint8_t* in, uint8_t* out, int len,
                             bool encrypt, uint8_t tag[16]) {
  // J0 = IV || 0x00000001; payload counters start at inc32(J0)
  uint8_t ctr[16 * 65];
  int nblocks = (len + 15) / 16;
  for (int b = 0; b <= nblocks; b++) {
    memcpy(ctr + 16 * b, iv, 12);
    uint32_t c = uint32_t(b) + 1;
    ctr[16 * b + 12] = uint8_t(c >> 24);
    ctr[16 * b + 13] = uint8_t(c >> 16);
    ctr[16 * b + 14] = uint8_t(c >> 8);
    ctr[16 * b + 15] = uint8_t(c);
  }
  uint8_t ks[16 * 65];
  aes_enc_blocks(g.aes, ctr, ks, nblocks + 1);  // ks[0..15] = E(J0)
  __m128i y = _mm_setzero_si128();
  y = ghash_update(y, g.h, aad, aad_len);
  if (encrypt) {
    for (int i = 0; i < len; i++) out[i] = in[i] ^ ks[16 + i];
    y = ghash_update(y, g.h, out, len);
  } else {
    y = ghash_update(y, g.h, in, len);   // ct hashed BEFORE it may be
    for (int i = 0; i < len; i++)        // overwritten by an in-place XOR
      out[i] = in[i] ^ ks[16 + i];
  }
  uint8_t lens[16] = {0};
  uint64_t abits = uint64_t(aad_len) * 8, cbits = uint64_t(len) * 8;
  for (int i = 0; i < 8; i++) {
    lens[i] = uint8_t(abits >> (56 - 8 * i));
    lens[8 + i] = uint8_t(cbits >> (56 - 8 * i));
  }
  y = ghash_update(y, g.h, lens, 16);
  __m128i t = _mm_xor_si128(bswap16_(y),
                            _mm_loadu_si128((const __m128i*)ks));
  _mm_storeu_si128((__m128i*)tag, t);
}

// Constant-time 16-byte tag compare (no early exit on mismatch byte).
static inline bool tag_eq(const uint8_t* a, const uint8_t* b) {
  uint32_t d = 0;
  for (int i = 0; i < 16; i++) d |= uint32_t(a[i] ^ b[i]);
  return d == 0;
}

}  // namespace ms2hw

#endif  // feature gate
