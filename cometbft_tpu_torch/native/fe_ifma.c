/* 8-way field exponentiation over GF(2^255-19) with AVX-512 IFMA.
 *
 * ZIP-215 decompression needs one fixed exponentiation x^((p-5)/8) per
 * point (~254 squarings) — half the cost of the whole batch-verify on
 * hosts without a device.  The chain is identical for every point, so
 * eight decompressions run in lockstep on 512-bit lanes: radix-2^52
 * limbs, vpmadd52{lo,hi}uq accumulating the 104-bit partial products
 * (the instructions IFMA exists for).  Runtime-dispatched: the scalar
 * radix-51 path in ed25519_msm.c remains the fallback.
 *
 * Layout: fe8 = 5 vectors; vector k holds limb k of 8 independent field
 * elements.  Limbs < 2^52; products fold at 2^260 == 608 (mod p)
 * (2^260 = 2^5 * 2^255 and 2^255 == 19).
 */

#if defined(__x86_64__)

#include <immintrin.h>
#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef __uint128_t u128;

#define TGT __attribute__((target("avx512f,avx512dq,avx512vl,avx512ifma")))

typedef struct { __m512i l[5]; } fe8;

#define MASK52 ((1ULL << 52) - 1)

TGT static inline __m512i mul52lo(__m512i acc, __m512i a, __m512i b) {
    return _mm512_madd52lo_epu64(acc, a, b);
}
TGT static inline __m512i mul52hi(__m512i acc, __m512i a, __m512i b) {
    return _mm512_madd52hi_epu64(acc, a, b);
}

/* h = f * g (8 lanes).  Full 10-limb accumulation (every t[k] stays well
 * under 2^56, so 64-bit lanes never wrap), one carry chain to bring every
 * limb under 2^52, then the high half folds down with x608
 * (t[k] + 608*t[k+5] < 2^52 + 2^61.3), and two more carry rounds leave
 * all limbs strictly < 2^52 — the IFMA operand requirement (vpmadd52
 * reads only the low 52 bits of each operand). */
TGT static void fe8_mul(fe8 *h, const fe8 *f, const fe8 *g) {
    const __m512i mask = _mm512_set1_epi64(MASK52);
    const __m512i c608 = _mm512_set1_epi64(608);
    __m512i t[10], c;
    for (int i = 0; i < 10; i++) t[i] = _mm512_setzero_si512();

    for (int i = 0; i < 5; i++) {
        for (int j = 0; j < 5; j++) {
            int k = i + j;
            t[k] = mul52lo(t[k], f->l[i], g->l[j]);
            t[k + 1] = mul52hi(t[k + 1], f->l[i], g->l[j]);
        }
    }
    /* normalize the full product to limbs < 2^52 */
    for (int k = 0; k < 9; k++) {
        c = _mm512_srli_epi64(t[k], 52);
        t[k] = _mm512_and_si512(t[k], mask);
        t[k + 1] = _mm512_add_epi64(t[k + 1], c);
    }
    /* t[9] overflow has weight 2^520 = (2^260)^2 == 608^2 */
    c = _mm512_srli_epi64(t[9], 52);
    t[9] = _mm512_and_si512(t[9], mask);
    t[0] = _mm512_add_epi64(
        t[0], _mm512_mullo_epi64(c, _mm512_set1_epi64(608 * 608)));
    /* fold the high half: weight 2^(52(k+5)) = 2^(52k) * 2^260 == 608 */
    for (int k = 0; k < 5; k++)
        t[k] = _mm512_add_epi64(t[k], _mm512_mullo_epi64(t[k + 5], c608));
    /* three carry rounds (fold-first so limb 0 is masked after its fold;
     * the third absorbs the corner where a round-2 carry leaves a limb at
     * exactly 2^52) */
    for (int round = 0; round < 3; round++) {
        c = _mm512_srli_epi64(t[4], 52);
        t[4] = _mm512_and_si512(t[4], mask);
        t[0] = _mm512_add_epi64(t[0], _mm512_mullo_epi64(c, c608));
        for (int k = 0; k < 4; k++) {
            c = _mm512_srli_epi64(t[k], 52);
            t[k] = _mm512_and_si512(t[k], mask);
            t[k + 1] = _mm512_add_epi64(t[k + 1], c);
        }
    }
    for (int k = 0; k < 5; k++) h->l[k] = t[k];
}

TGT static void fe8_sq(fe8 *h, const fe8 *f) { fe8_mul(h, f, f); }

/* out = z^(2^252 - 3), the (p-5)/8 exponent chain (matches fe_pow2523) */
TGT static void fe8_pow2523(fe8 *out, const fe8 *z) {
    fe8 t0, t1, t2;
    int i;
    fe8_sq(&t0, z);
    fe8_sq(&t1, &t0); fe8_sq(&t1, &t1);
    fe8_mul(&t1, z, &t1);
    fe8_mul(&t0, &t0, &t1);
    fe8_sq(&t0, &t0);
    fe8_mul(&t0, &t1, &t0);
    fe8_sq(&t1, &t0);
    for (i = 1; i < 5; i++) fe8_sq(&t1, &t1);
    fe8_mul(&t0, &t1, &t0);
    fe8_sq(&t1, &t0);
    for (i = 1; i < 10; i++) fe8_sq(&t1, &t1);
    fe8_mul(&t1, &t1, &t0);
    fe8_sq(&t2, &t1);
    for (i = 1; i < 20; i++) fe8_sq(&t2, &t2);
    fe8_mul(&t1, &t2, &t1);
    fe8_sq(&t1, &t1);
    for (i = 1; i < 10; i++) fe8_sq(&t1, &t1);
    fe8_mul(&t0, &t1, &t0);
    fe8_sq(&t1, &t0);
    for (i = 1; i < 50; i++) fe8_sq(&t1, &t1);
    fe8_mul(&t1, &t1, &t0);
    fe8_sq(&t2, &t1);
    for (i = 1; i < 100; i++) fe8_sq(&t2, &t2);
    fe8_mul(&t1, &t2, &t1);
    fe8_sq(&t1, &t1);
    for (i = 1; i < 50; i++) fe8_sq(&t1, &t1);
    fe8_mul(&t0, &t1, &t0);
    fe8_sq(&t0, &t0); fe8_sq(&t0, &t0);
    fe8_mul(out, &t0, z);
}

/* Batched u^((p-5)/8): in/out as 8 field elements in radix-52 limb-major
 * layout (limb k of lane j at in[5*j + k]), values fully reduced. */
TGT static void fe8_load(fe8 *h, const u64 *in) {
    u64 tmp[8];
    for (int k = 0; k < 5; k++) {
        for (int j = 0; j < 8; j++) tmp[j] = in[5 * j + k];
        h->l[k] = _mm512_loadu_si512((const void *)tmp);
    }
}

TGT static void fe8_store(u64 *out, const fe8 *h) {
    u64 tmp[8];
    for (int k = 0; k < 5; k++) {
        _mm512_storeu_si512((void *)tmp, h->l[k]);
        for (int j = 0; j < 8; j++) out[5 * j + k] = tmp[j];
    }
}

TGT void cmtpu_fe8_pow2523(const u64 *in, u64 *out) {
    fe8 z, r;
    fe8_load(&z, in);
    fe8_pow2523(&r, &z);
    fe8_store(out, &r);
}

int cmtpu_have_ifma(void) {
    return __builtin_cpu_supports("avx512ifma") &&
           __builtin_cpu_supports("avx512dq") &&
           __builtin_cpu_supports("avx512vl");
}

#else
typedef unsigned long long u64x;
void cmtpu_fe8_pow2523(const void *in, void *out) { (void)in; (void)out; }
int cmtpu_have_ifma(void) { return 0; }
#endif
