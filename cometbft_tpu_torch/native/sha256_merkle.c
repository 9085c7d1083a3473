/* Native RFC-6962 Merkle tree (reference: crypto/merkle/tree.go:11-27).
 *
 * The Python host tier pays ~1.5us of interpreter/hashlib dispatch per node
 * on top of the ~0.3us of actual compression work; at 64k leaves (131k
 * hashes) that overhead IS the cost.  This file keeps the whole
 * level-synchronous tree loop in C: leaf = SHA256(0x00 || data),
 * inner = SHA256(0x01 || left || right), odd node promoted — identical to
 * the split-point recursion (tree.go:68-98 proves the equivalence).
 */

#include <stdint.h>
#include <string.h>
#include <stddef.h>

#if defined(__x86_64__)
#include <immintrin.h>
#define CMTPU_X86 1
#endif

typedef uint8_t u8;
typedef uint32_t u32;
typedef uint64_t u64;

static const u32 K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_block_soft(u32 st[8], const u8 *p) {
    u32 w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((u32)p[4 * i] << 24) | ((u32)p[4 * i + 1] << 16) |
               ((u32)p[4 * i + 2] << 8) | (u32)p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        u32 s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
        u32 s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = st[0], b = st[1], c = st[2], d = st[3];
    u32 e = st[4], f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 64; i++) {
        u32 S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
        u32 ch = (e & f) ^ (~e & g);
        u32 t1 = h + S1 + ch + K[i] + w[i];
        u32 S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
        u32 mj = (a & b) ^ (a & c) ^ (b & c);
        u32 t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

#ifdef CMTPU_X86
/* SHA-NI one-block compression (state in the ABEF/CDGH arrangement the
 * sha256rnds2 instruction wants).  ~5-10x the portable rounds on cores
 * with the extension; runtime-dispatched below. */
__attribute__((target("sha,sse4.1")))
static void sha256_block_ni(u32 st[8], const u8 *p) {
    const __m128i SHUF = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                        0x0405060700010203ULL);
    __m128i T = _mm_loadu_si128((const __m128i *)&st[0]);   /* DCBA */
    __m128i S1 = _mm_loadu_si128((const __m128i *)&st[4]);  /* HGFE */
    T = _mm_shuffle_epi32(T, 0xB1);                         /* CDAB */
    S1 = _mm_shuffle_epi32(S1, 0x1B);                       /* EFGH */
    __m128i S0 = _mm_alignr_epi8(T, S1, 8);                 /* ABEF */
    S1 = _mm_blend_epi16(S1, T, 0xF0);                      /* CDGH */
    const __m128i ABEF = S0, CDGH = S1;

    __m128i M0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 0)), SHUF);
    __m128i M1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 16)), SHUF);
    __m128i M2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 32)), SHUF);
    __m128i M3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 48)), SHUF);
    __m128i MSG, TMP;

#define RND4(M, k)                                                      \
    MSG = _mm_add_epi32(M, _mm_loadu_si128((const __m128i *)&K[k]));    \
    S1 = _mm_sha256rnds2_epu32(S1, S0, MSG);                            \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                                 \
    S0 = _mm_sha256rnds2_epu32(S0, S1, MSG)
/* After processing group i (message reg Mcur, predecessor Mprev):
 * complete W for group i+1 (Mnext = msg2(Mnext + alignr(Mcur,Mprev), Mcur))
 * and start group i+3's schedule (Mprev = msg1(Mprev, Mcur)). */
#define SCHED(Mnext, Mprev, Mcur)                                       \
    TMP = _mm_alignr_epi8(Mcur, Mprev, 4);                              \
    Mnext = _mm_add_epi32(Mnext, TMP);                                  \
    Mnext = _mm_sha256msg2_epu32(Mnext, Mcur);                          \
    Mprev = _mm_sha256msg1_epu32(Mprev, Mcur)

    RND4(M0, 0);
    RND4(M1, 4);  M0 = _mm_sha256msg1_epu32(M0, M1);
    RND4(M2, 8);  M1 = _mm_sha256msg1_epu32(M1, M2);
    RND4(M3, 12); SCHED(M0, M2, M3);
    RND4(M0, 16); SCHED(M1, M3, M0);
    RND4(M1, 20); SCHED(M2, M0, M1);
    RND4(M2, 24); SCHED(M3, M1, M2);
    RND4(M3, 28); SCHED(M0, M2, M3);
    RND4(M0, 32); SCHED(M1, M3, M0);
    RND4(M1, 36); SCHED(M2, M0, M1);
    RND4(M2, 40); SCHED(M3, M1, M2);
    RND4(M3, 44); SCHED(M0, M2, M3);
    RND4(M0, 48); SCHED(M1, M3, M0);
    RND4(M1, 52); SCHED(M2, M0, M1);
    RND4(M2, 56); SCHED(M3, M1, M2);
    RND4(M3, 60);
#undef RND4
#undef SCHED

    S0 = _mm_add_epi32(S0, ABEF);
    S1 = _mm_add_epi32(S1, CDGH);
    T = _mm_shuffle_epi32(S0, 0x1B);                        /* FEBA */
    S1 = _mm_shuffle_epi32(S1, 0xB1);                       /* DCHG */
    S0 = _mm_blend_epi16(T, S1, 0xF0);                      /* DCBA */
    S1 = _mm_alignr_epi8(S1, T, 8);                         /* HGFE */
    _mm_storeu_si128((__m128i *)&st[0], S0);
    _mm_storeu_si128((__m128i *)&st[4], S1);
}
#endif

static int g_has_sha_ni = -1;

#ifdef CMTPU_X86
#include <cpuid.h>
/* CPUID leaf 7 EBX bit 29 = SHA extensions.  Probed directly because
 * __builtin_cpu_supports("sha") only exists from gcc 11. */
static int detect_sha_ni(void) {
    unsigned int a, b, c, d;
    if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return 0;
    return (b >> 29) & 1;
}
#endif

static void sha256_block(u32 st[8], const u8 *p) {
#ifdef CMTPU_X86
    if (g_has_sha_ni < 0) g_has_sha_ni = detect_sha_ni();
    if (g_has_sha_ni) { sha256_block_ni(st, p); return; }
#endif
    sha256_block_soft(st, p);
}

static void sha256(const u8 *msg, u64 len, u8 out[32]) {
    u32 st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    u64 i = 0;
    for (; i + 64 <= len; i += 64) sha256_block(st, msg + i);
    u8 tail[128];
    u64 rem = len - i;
    memcpy(tail, msg + i, rem);
    tail[rem] = 0x80;
    u64 padlen = (rem + 9 <= 64) ? 64 : 128;
    memset(tail + rem + 1, 0, padlen - rem - 9);
    u64 bits = len * 8;
    for (int j = 0; j < 8; j++) tail[padlen - 1 - j] = (u8)(bits >> (8 * j));
    sha256_block(st, tail);
    if (padlen == 128) sha256_block(st, tail + 64);
    for (int j = 0; j < 8; j++) {
        out[4 * j] = (u8)(st[j] >> 24);
        out[4 * j + 1] = (u8)(st[j] >> 16);
        out[4 * j + 2] = (u8)(st[j] >> 8);
        out[4 * j + 3] = (u8)st[j];
    }
}

/* leaves: concatenated leaf bytes; offs[n+1] byte offsets into buf.
 * scratch: caller-provided n*32 bytes.  out: 32 bytes.  n >= 1. */
void cmtpu_merkle_root(long n, const u8 *buf, const u64 *offs, u8 *scratch,
                       u8 *out) {
    u8 tmp[1 + 64];
    for (long i = 0; i < n; i++) {
        u64 len = offs[i + 1] - offs[i];
        if (len <= 64) {
            tmp[0] = 0x00;
            memcpy(tmp + 1, buf + offs[i], len);
            sha256(tmp, len + 1, scratch + 32 * i);
        } else {
            /* rare: leaf > 64 bytes; hash prefix+data without copying by
             * streaming two segments */
            u8 big[1 + 1024];
            if (len <= 1024) {
                big[0] = 0x00;
                memcpy(big + 1, buf + offs[i], len);
                sha256(big, len + 1, scratch + 32 * i);
            } else {
                /* arbitrarily long leaf: one-shot heap-free streaming */
                u32 st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                             0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
                u8 blk[64];
                blk[0] = 0x00;
                u64 total = len + 1;
                u64 filled = 1, pos = 0;
                while (pos < len) {
                    u64 take = 64 - filled;
                    if (take > len - pos) take = len - pos;
                    memcpy(blk + filled, buf + offs[i] + pos, take);
                    filled += take; pos += take;
                    if (filled == 64) { sha256_block(st, blk); filled = 0; }
                }
                u8 tail2[128];
                memcpy(tail2, blk, filled);
                tail2[filled] = 0x80;
                u64 padlen = (filled + 9 <= 64) ? 64 : 128;
                memset(tail2 + filled + 1, 0, padlen - filled - 9);
                u64 bits = total * 8;
                for (int j = 0; j < 8; j++)
                    tail2[padlen - 1 - j] = (u8)(bits >> (8 * j));
                sha256_block(st, tail2);
                if (padlen == 128) sha256_block(st, tail2 + 64);
                for (int j = 0; j < 8; j++) {
                    scratch[32 * i + 4 * j] = (u8)(st[j] >> 24);
                    scratch[32 * i + 4 * j + 1] = (u8)(st[j] >> 16);
                    scratch[32 * i + 4 * j + 2] = (u8)(st[j] >> 8);
                    scratch[32 * i + 4 * j + 3] = (u8)st[j];
                }
            }
        }
    }
    u8 inner[65];
    inner[0] = 0x01;
    long lvl = n;
    while (lvl > 1) {
        long nxt = 0;
        for (long i = 0; i + 1 < lvl; i += 2) {
            memcpy(inner + 1, scratch + 32 * i, 32);
            memcpy(inner + 33, scratch + 32 * (i + 1), 32);
            sha256(inner, 65, scratch + 32 * nxt);
            nxt++;
        }
        if (lvl & 1) {
            memmove(scratch + 32 * nxt, scratch + 32 * (lvl - 1), 32);
            nxt++;
        }
        lvl = nxt;
    }
    memcpy(out, scratch, 32);
}

/* Plain batch SHA-256 over n variable-length messages (offs[n+1]). */
void cmtpu_sha256_batch(long n, const u8 *buf, const u64 *offs, u8 *out) {
    for (long i = 0; i < n; i++)
        sha256(buf + offs[i], offs[i + 1] - offs[i], out + 32 * i);
}

/* ---- SHA-512 (batch challenge hashing for the ed25519 batch path) ---- */

static const u64 K512[80] = {
    0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL,
    0xE9B5DBA58189DBBCULL, 0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL,
    0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL, 0xD807AA98A3030242ULL,
    0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,
    0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL,
    0xC19BF174CF692694ULL, 0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL,
    0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL, 0x2DE92C6F592B0275ULL,
    0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,
    0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL,
    0xBF597FC7BEEF0EE4ULL, 0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL,
    0x06CA6351E003826FULL, 0x142929670A0E6E70ULL, 0x27B70A8546D22FFCULL,
    0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,
    0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL,
    0x92722C851482353BULL, 0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL,
    0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL, 0xD192E819D6EF5218ULL,
    0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,
    0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL,
    0x34B0BCB5E19B48A8ULL, 0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL,
    0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL, 0x748F82EE5DEFB2FCULL,
    0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,
    0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL,
    0xC67178F2E372532BULL, 0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL,
    0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL, 0x06F067AA72176FBAULL,
    0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,
    0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL,
    0x431D67C49C100D4CULL, 0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL,
    0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL,
};
static const u64 H512[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

#define ROR64(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

static void sha512_block(u64 st[8], const u8 *p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        u64 v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | p[8 * i + j];
        w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = ROR64(w[i - 15], 1) ^ ROR64(w[i - 15], 8) ^ (w[i - 15] >> 7);
        u64 s1 = ROR64(w[i - 2], 19) ^ ROR64(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = st[0], b = st[1], c = st[2], d = st[3];
    u64 e = st[4], f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 80; i++) {
        u64 S1 = ROR64(e, 14) ^ ROR64(e, 18) ^ ROR64(e, 41);
        u64 ch = (e & f) ^ (~e & g);
        u64 t1 = h + S1 + ch + K512[i] + w[i];
        u64 S0 = ROR64(a, 28) ^ ROR64(a, 34) ^ ROR64(a, 39);
        u64 mj = (a & b) ^ (a & c) ^ (b & c);
        u64 t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

static void sha512(const u8 *msg, u64 len, u8 out[64]) {
    u64 st[8];
    memcpy(st, H512, sizeof st);
    u64 i = 0;
    for (; i + 128 <= len; i += 128) sha512_block(st, msg + i);
    u8 tail[256];
    u64 rem = len - i;
    memcpy(tail, msg + i, rem);
    tail[rem] = 0x80;
    u64 padlen = (rem + 17 <= 128) ? 128 : 256;
    memset(tail + rem + 1, 0, padlen - rem - 17);
    memset(tail + padlen - 16, 0, 8); /* high 64 bits of the 128-bit length */
    u64 bits = len * 8;
    for (int j = 0; j < 8; j++) tail[padlen - 1 - j] = (u8)(bits >> (8 * j));
    sha512_block(st, tail);
    if (padlen == 256) sha512_block(st, tail + 128);
    for (int j = 0; j < 8; j++)
        for (int k = 0; k < 8; k++)
            out[8 * j + k] = (u8)(st[j] >> (56 - 8 * k));
}

/* Batch SHA-512 over n variable-length messages (offs[n+1]); out n*64. */
void cmtpu_sha512_batch(long n, const u8 *buf, const u64 *offs, u8 *out) {
    for (long i = 0; i < n; i++)
        sha512(buf + offs[i], offs[i + 1] - offs[i], out + 64 * i);
}

/* Inclusion-proof support (crypto/merkle/proof.go:35-49): build every tree
 * level into `levels` (leaf level first; each level of size s followed by
 * one of size (s+1)/2, odd node copied up), then gather each leaf's aunts
 * bottom-up.  aunts: stride 32*max_depth bytes per leaf; counts[i] = number
 * of aunts for leaf i (a promoted odd node contributes none at that level).
 * Caller sizes `levels` to 32 * (sum of all level sizes). */
void cmtpu_merkle_levels(long n, const u8 *buf, const u64 *offs, u8 *levels) {
    u8 tmp[1 + 64];
    u8 *cur = levels;
    for (long i = 0; i < n; i++) {
        u64 len = offs[i + 1] - offs[i];
        if (len <= 64) {
            tmp[0] = 0x00;
            memcpy(tmp + 1, buf + offs[i], len);
            sha256(tmp, len + 1, cur + 32 * i);
        } else {
            u8 big[1 + 4096];
            if (len <= 4096) {
                big[0] = 0x00;
                memcpy(big + 1, buf + offs[i], len);
                sha256(big, len + 1, cur + 32 * i);
            } else {
                /* fall back: leaf-hash via the scratch streaming path in
                 * cmtpu_merkle_root's shape; leaves this large do not occur
                 * in block data (txs are size-bounded), keep it simple */
                u64 one_off[2] = {0, len};
                u8 unused_scratch[32];
                (void)unused_scratch;
                cmtpu_merkle_root(1, buf + offs[i], one_off, cur + 32 * i,
                                  cur + 32 * i);
            }
        }
    }
    long size = n;
    u8 inner[65];
    inner[0] = 0x01;
    while (size > 1) {
        u8 *nxt = cur + 32 * size;
        long out_i = 0;
        for (long i = 0; i + 1 < size; i += 2) {
            memcpy(inner + 1, cur + 32 * i, 32);
            memcpy(inner + 33, cur + 32 * (i + 1), 32);
            sha256(inner, 65, nxt + 32 * out_i);
            out_i++;
        }
        if (size & 1) {
            memcpy(nxt + 32 * out_i, cur + 32 * (size - 1), 32);
            out_i++;
        }
        cur = nxt;
        size = out_i;
    }
}

void cmtpu_merkle_aunts(long n, const u8 *levels, long max_depth, u8 *aunts,
                        int32_t *counts) {
    /* level start offsets (in nodes) */
    long starts[64], sizes[64], nlevels = 0;
    long size = n, acc = 0;
    while (1) {
        starts[nlevels] = acc;
        sizes[nlevels] = size;
        acc += size;
        nlevels++;
        if (size == 1) break;
        size = (size + 1) / 2;
    }
    for (long i = 0; i < n; i++) {
        long idx = i, cnt = 0;
        u8 *dst = aunts + (u64)i * 32 * max_depth;
        for (long l = 0; l + 1 < nlevels; l++) {
            long sib = idx ^ 1;
            if (sib < sizes[l]) {
                memcpy(dst + 32 * cnt,
                       levels + 32 * (starts[l] + sib), 32);
                cnt++;
            }
            idx >>= 1;
        }
        counts[i] = (int32_t)cnt;
    }
}

/* Device-path leaf packing: SHA-256-pad n messages straight into the
 * lane-major big-endian word layout [bmax, 16, n] the TPU Merkle kernel
 * consumes (ops/sha256_kernel.pack_messages).  The numpy path pays an
 * 8 MB strided transpose at 64k leaves; here padding and transpose fuse
 * in one pass, tiled so the per-tile scratch stays cache-resident and
 * every out write is a contiguous run of lanes. */
#include <stdlib.h>

void cmtpu_sha256_pack(long n, const u8 *flat, const u64 *offs, long bmax,
                       u32 *out, int32_t *nblocks) {
    enum { T = 64 };
    long tile = n < T ? n : T;
    u8 *scratch = (u8 *)malloc((size_t)tile * (size_t)bmax * 64);
    if (!scratch) { /* caller pre-zeroed nothing; signal via nblocks */
        for (long i = 0; i < n; i++) nblocks[i] = -1;
        return;
    }
    const long row_sz = bmax * 64;
    for (long base = 0; base < n; base += T) {
        long t = n - base < T ? n - base : T;
        memset(scratch, 0, (size_t)t * row_sz);
        for (long j = 0; j < t; j++) {
            long i = base + j;
            u64 len = offs[i + 1] - offs[i];
            long nb = (long)((len + 8) / 64 + 1);
            nblocks[i] = (int32_t)nb;
            u8 *row = scratch + j * row_sz;
            memcpy(row, flat + offs[i], len);
            row[len] = 0x80;
            u64 bits = len * 8;
            u8 *p = row + nb * 64 - 8;
            for (int k = 0; k < 8; k++)
                p[k] = (u8)(bits >> (8 * (7 - k)));
        }
        for (long bw = 0; bw < bmax * 16; bw++) {
            u32 *dst = out + bw * n + base;
            const u8 *src = scratch + bw * 4;
            for (long j = 0; j < t; j++) {
                const u8 *q = src + j * row_sz;
                dst[j] = ((u32)q[0] << 24) | ((u32)q[1] << 16) |
                         ((u32)q[2] << 8) | (u32)q[3];
            }
        }
    }
    free(scratch);
}
