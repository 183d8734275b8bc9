/* Batched SHA-256 for SSZ merkleization — the native runtime component
 * backing hash_tree_root throughput (SURVEY.md §7.3 hard part #6; the
 * reference's native plane is its C BLS binding, utils/bls.py:17-22).
 *
 * API (ctypes, see consensus_specs_tpu_torch/utils/native_sha256.py):
 *   void sha256_hash_pairs(const uint8_t* in, uint8_t* out, size_t n)
 *     - hashes n independent 64-byte messages (pairs of 32-byte tree nodes)
 *       into n 32-byte digests: one C call per MERKLE LAYER instead of one
 *       Python hashlib call per node pair. Every message is exactly one
 *       data block + one constant padding block, so the whole layer runs
 *       without branching or allocation.
 *   void sha256_hash_many(const uint8_t* in, const uint64_t* lens,
 *                         uint8_t* out, size_t n)
 *     - hashes n independent VARIABLE-length messages (concatenated in
 *       `in`, per-message byte lengths in `lens`) into n 32-byte digests:
 *       one C call per batch of messages.
 *
 * Build: on first use, by utils/native_sha256.py (cc -O3 -fPIC -shared),
 * into the package's _build/ directory.
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

static const uint32_t K[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2
};

#define ROR(x,n) (((x) >> (n)) | ((x) << (32 - (n))))

static void compress(uint32_t state[8], const uint8_t block[64]) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)block[4*i] << 24) | ((uint32_t)block[4*i+1] << 16)
             | ((uint32_t)block[4*i+2] << 8) | block[4*i+3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ROR(w[i-15], 7) ^ ROR(w[i-15], 18) ^ (w[i-15] >> 3);
        uint32_t s1 = ROR(w[i-2], 17) ^ ROR(w[i-2], 19) ^ (w[i-2] >> 10);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K[i] + w[i];
        uint32_t S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

static const uint32_t IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19
};

/* the padding block for a 64-byte message is constant: 0x80, zeros, and the
 * 512-bit length in the trailing 8 bytes */
static const uint8_t PAD64[64] = {
    0x80, 0, 0, 0, 0, 0, 0, 0,  0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0,  0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0,  0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0,  0, 0, 0, 0, 0, 0, 0x02, 0x00
};

/* ---- SHA-NI fast path ----------------------------------------------------
 * x86 SHA extensions run the whole compression in hardware (~4-8x over the
 * scalar rounds above). Compiled with a per-function target attribute so
 * the object still builds and loads on any x86-64 toolchain; selected at
 * runtime via cpuid, everything else falls back to the scalar path. */
#if defined(__x86_64__) || defined(_M_X64)
#define HAVE_SHA_NI_BUILD 1
#include <immintrin.h>

__attribute__((target("sha,sse4.1")))
static void compress_ni(uint32_t state[8], const uint8_t block[64]) {
    __m128i STATE0, STATE1, MSG, TMP, TMSG0, TMSG1, TMSG2, TMSG3;
    __m128i ABEF_SAVE, CDGH_SAVE;
    const __m128i MASK =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

    TMP = _mm_loadu_si128((const __m128i*)&state[0]);
    STATE1 = _mm_loadu_si128((const __m128i*)&state[4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);          /* CDAB */
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);    /* EFGH */
    STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);    /* ABEF */
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0); /* CDGH */
    ABEF_SAVE = STATE0;
    CDGH_SAVE = STATE1;

    /* rounds 0-3 */
    TMSG0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 0)), MASK);
    MSG = _mm_add_epi32(TMSG0,
        _mm_set_epi64x(0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    /* rounds 4-7 */
    TMSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 16)), MASK);
    MSG = _mm_add_epi32(TMSG1,
        _mm_set_epi64x(0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG0 = _mm_sha256msg1_epu32(TMSG0, TMSG1);

    /* rounds 8-11 */
    TMSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 32)), MASK);
    MSG = _mm_add_epi32(TMSG2,
        _mm_set_epi64x(0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG1 = _mm_sha256msg1_epu32(TMSG1, TMSG2);

    /* rounds 12-15 */
    TMSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 48)), MASK);
    MSG = _mm_add_epi32(TMSG3,
        _mm_set_epi64x(0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG3, TMSG2, 4);
    TMSG0 = _mm_add_epi32(TMSG0, TMP);
    TMSG0 = _mm_sha256msg2_epu32(TMSG0, TMSG3);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG2 = _mm_sha256msg1_epu32(TMSG2, TMSG3);

    /* rounds 16-19 */
    MSG = _mm_add_epi32(TMSG0,
        _mm_set_epi64x(0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG0, TMSG3, 4);
    TMSG1 = _mm_add_epi32(TMSG1, TMP);
    TMSG1 = _mm_sha256msg2_epu32(TMSG1, TMSG0);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG3 = _mm_sha256msg1_epu32(TMSG3, TMSG0);

    /* rounds 20-23 */
    MSG = _mm_add_epi32(TMSG1,
        _mm_set_epi64x(0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG1, TMSG0, 4);
    TMSG2 = _mm_add_epi32(TMSG2, TMP);
    TMSG2 = _mm_sha256msg2_epu32(TMSG2, TMSG1);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG0 = _mm_sha256msg1_epu32(TMSG0, TMSG1);

    /* rounds 24-27 */
    MSG = _mm_add_epi32(TMSG2,
        _mm_set_epi64x(0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG2, TMSG1, 4);
    TMSG3 = _mm_add_epi32(TMSG3, TMP);
    TMSG3 = _mm_sha256msg2_epu32(TMSG3, TMSG2);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG1 = _mm_sha256msg1_epu32(TMSG1, TMSG2);

    /* rounds 28-31 */
    MSG = _mm_add_epi32(TMSG3,
        _mm_set_epi64x(0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG3, TMSG2, 4);
    TMSG0 = _mm_add_epi32(TMSG0, TMP);
    TMSG0 = _mm_sha256msg2_epu32(TMSG0, TMSG3);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG2 = _mm_sha256msg1_epu32(TMSG2, TMSG3);

    /* rounds 32-35 */
    MSG = _mm_add_epi32(TMSG0,
        _mm_set_epi64x(0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG0, TMSG3, 4);
    TMSG1 = _mm_add_epi32(TMSG1, TMP);
    TMSG1 = _mm_sha256msg2_epu32(TMSG1, TMSG0);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG3 = _mm_sha256msg1_epu32(TMSG3, TMSG0);

    /* rounds 36-39 */
    MSG = _mm_add_epi32(TMSG1,
        _mm_set_epi64x(0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG1, TMSG0, 4);
    TMSG2 = _mm_add_epi32(TMSG2, TMP);
    TMSG2 = _mm_sha256msg2_epu32(TMSG2, TMSG1);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG0 = _mm_sha256msg1_epu32(TMSG0, TMSG1);

    /* rounds 40-43 */
    MSG = _mm_add_epi32(TMSG2,
        _mm_set_epi64x(0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG2, TMSG1, 4);
    TMSG3 = _mm_add_epi32(TMSG3, TMP);
    TMSG3 = _mm_sha256msg2_epu32(TMSG3, TMSG2);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG1 = _mm_sha256msg1_epu32(TMSG1, TMSG2);

    /* rounds 44-47 */
    MSG = _mm_add_epi32(TMSG3,
        _mm_set_epi64x(0x106AA070F40E3585ULL, 0xD6990624D192E819ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG3, TMSG2, 4);
    TMSG0 = _mm_add_epi32(TMSG0, TMP);
    TMSG0 = _mm_sha256msg2_epu32(TMSG0, TMSG3);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG2 = _mm_sha256msg1_epu32(TMSG2, TMSG3);

    /* rounds 48-51 */
    MSG = _mm_add_epi32(TMSG0,
        _mm_set_epi64x(0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG0, TMSG3, 4);
    TMSG1 = _mm_add_epi32(TMSG1, TMP);
    TMSG1 = _mm_sha256msg2_epu32(TMSG1, TMSG0);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    TMSG3 = _mm_sha256msg1_epu32(TMSG3, TMSG0);

    /* rounds 52-55 */
    MSG = _mm_add_epi32(TMSG1,
        _mm_set_epi64x(0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG1, TMSG0, 4);
    TMSG2 = _mm_add_epi32(TMSG2, TMP);
    TMSG2 = _mm_sha256msg2_epu32(TMSG2, TMSG1);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    /* rounds 56-59 */
    MSG = _mm_add_epi32(TMSG2,
        _mm_set_epi64x(0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(TMSG2, TMSG1, 4);
    TMSG3 = _mm_add_epi32(TMSG3, TMP);
    TMSG3 = _mm_sha256msg2_epu32(TMSG3, TMSG2);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    /* rounds 60-63 */
    MSG = _mm_add_epi32(TMSG3,
        _mm_set_epi64x(0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    TMP = _mm_shuffle_epi32(STATE0, 0x1B);       /* FEBA */
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    /* DCHG */
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); /* DCBA */
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    /* HGFE */
    _mm_storeu_si128((__m128i*)&state[0], STATE0);
    _mm_storeu_si128((__m128i*)&state[4], STATE1);
}

__attribute__((target("sha,sse4.1")))
static void sha256_64_ni(const uint8_t in[64], uint8_t out[32]) {
    uint32_t st[8];
    memcpy(st, IV, sizeof st);
    compress_ni(st, in);
    compress_ni(st, PAD64);
    for (int i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(st[i] >> 24);
        out[4*i+1] = (uint8_t)(st[i] >> 16);
        out[4*i+2] = (uint8_t)(st[i] >> 8);
        out[4*i+3] = (uint8_t)(st[i]);
    }
}
#endif /* __x86_64__ */

/* 0 = undetected, 1 = SHA-NI, -1 = scalar only */
static int sha_ni_state = 0;

#if defined(HAVE_SHA_NI_BUILD)
#include <cpuid.h>
#endif

static int use_sha_ni(void) {
    if (sha_ni_state == 0) {
#if defined(HAVE_SHA_NI_BUILD)
        unsigned a = 0, b = 0, c = 0, d = 0;
        int ok = 0;
        if (__get_cpuid_count(7, 0, &a, &b, &c, &d))
            ok = (b >> 29) & 1;                    /* CPUID.7.0:EBX.SHA */
        if (ok) {
            __cpuid(1, a, b, c, d);
            ok = (c >> 19) & 1;                    /* CPUID.1:ECX.SSE4.1 */
        }
        sha_ni_state = ok ? 1 : -1;
#else
        sha_ni_state = -1;
#endif
    }
    return sha_ni_state == 1;
}

static void sha256_64(const uint8_t in[64], uint8_t out[32]) {
    uint32_t st[8];
    memcpy(st, IV, sizeof st);
    compress(st, in);
    compress(st, PAD64);
    for (int i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(st[i] >> 24);
        out[4*i+1] = (uint8_t)(st[i] >> 16);
        out[4*i+2] = (uint8_t)(st[i] >> 8);
        out[4*i+3] = (uint8_t)(st[i]);
    }
}

void sha256_hash_pairs(const uint8_t* in, uint8_t* out, size_t n) {
#if defined(HAVE_SHA_NI_BUILD)
    if (use_sha_ni()) {
        for (size_t i = 0; i < n; i++)
            sha256_64_ni(in + 64 * i, out + 32 * i);
        return;
    }
#endif
    for (size_t i = 0; i < n; i++)
        sha256_64(in + 64 * i, out + 32 * i);
}

static void sha256_any(const uint8_t* msg, size_t len, uint8_t* out) {
    uint32_t st[8];
    memcpy(st, IV, sizeof st);
    size_t full = len / 64;
    for (size_t b = 0; b < full; b++)
        compress(st, msg + 64 * b);
    size_t rem = len - 64 * full;
    uint8_t tail[128];
    memset(tail, 0, sizeof tail);
    memcpy(tail, msg + 64 * full, rem);
    tail[rem] = 0x80;
    size_t tlen = (rem + 9 <= 64) ? 64 : 128;
    uint64_t bitlen = (uint64_t)len * 8;
    for (int k = 0; k < 8; k++)
        tail[tlen - 1 - k] = (uint8_t)(bitlen >> (8 * k));
    compress(st, tail);
    if (tlen == 128)
        compress(st, tail + 64);
    for (int i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(st[i] >> 24);
        out[4*i+1] = (uint8_t)(st[i] >> 16);
        out[4*i+2] = (uint8_t)(st[i] >> 8);
        out[4*i+3] = (uint8_t)(st[i]);
    }
}

void sha256_hash_many(const uint8_t* in, const uint64_t* lens,
                      uint8_t* out, size_t n) {
    size_t off = 0;
#if defined(HAVE_SHA_NI_BUILD)
    if (use_sha_ni()) {
        for (size_t i = 0; i < n; i++) {
            size_t len = (size_t)lens[i];
            if (len == 64) {
                sha256_64_ni(in + off, out + 32 * i);
            } else {
                sha256_any(in + off, len, out + 32 * i);
            }
            off += len;
        }
        return;
    }
#endif
    for (size_t i = 0; i < n; i++) {
        size_t len = (size_t)lens[i];
        sha256_any(in + off, len, out + 32 * i);
        off += len;
    }
}
