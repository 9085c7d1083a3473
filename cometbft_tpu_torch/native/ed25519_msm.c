/* Native host-tier ed25519 batch verification.
 *
 * The reference's CPU batch path (crypto/ed25519/ed25519.go:196-228,
 * curve25519-voi BatchVerifier) wins over per-signature verification by
 * checking ONE random-linear-combination equation
 *
 *     [8]( [sum z_i s_i mod L] B  -  sum [z_i] R_i  -  sum [z_i h_i mod L] A_i ) == identity
 *
 * with 128-bit random z_i, evaluated as a single multi-scalar
 * multiplication (Pippenger bucket method).  This file is the TPU-framework
 * analog for hosts without a device: radix-51 field arithmetic, extended
 * twisted-Edwards points, ZIP-215 decompression (non-canonical y accepted,
 * x=0 with sign bit rejected — crypto/ed25519/ed25519.go:27-29 semantics,
 * anchored by cometbft_tpu/crypto/ed25519_pure.py), and a variable-time MSM.
 * Scalar arithmetic mod L (hashing, z*h products, the B coefficient) stays
 * in Python, which also drives bisection on batch failure to recover the
 * per-signature bitmap the BatchVerifier seam promises.
 *
 * Variable-time throughout: verification handles public data only.
 */

#include <stdint.h>
#include <string.h>
#include <stddef.h>

typedef uint64_t u64;
typedef __uint128_t u128;
typedef uint8_t u8;

#define MASK51 ((1ULL << 51) - 1)

typedef struct { u64 v[5]; } fe;
typedef struct { fe X, Y, Z, T; } ge; /* extended: x=X/Z y=Y/Z T=XY/Z */

static const fe FE_ONE = {{1, 0, 0, 0, 0}};

/* d = -121665/121666 mod p, radix-51 */
static const fe FE_D = {{
    929955233495203ULL, 466365720129213ULL, 1662059464998953ULL,
    2033849074728123ULL, 1442794654840575ULL}};
/* 2d mod p */
static const fe FE_2D = {{
    1859910466990425ULL, 932731440258426ULL, 1072319116312658ULL,
    1815898335770999ULL, 633789495995903ULL}};
/* sqrt(-1) mod p */
static const fe FE_SQRTM1 = {{
    1718705420411056ULL, 234908883556509ULL, 2233514472574048ULL,
    2117202627021982ULL, 765476049583133ULL}};

/* base point B, affine, radix-51 */
static const fe FE_BX = {{
    1738742601995546ULL, 1146398526822698ULL, 2070867633025821ULL,
    562264141797630ULL, 587772402128613ULL}};
static const fe FE_BY = {{
    1801439850948184ULL, 1351079888211148ULL, 450359962737049ULL,
    900719925474099ULL, 1801439850948198ULL}};

static void fe_add(fe *h, const fe *f, const fe *g) {
    for (int i = 0; i < 5; i++) h->v[i] = f->v[i] + g->v[i];
}

/* h = f + 4p - g: subtrahend limbs up to 2^53 stay positive.  Callers
 * fe_carry the result before it feeds a multiplication (mul/sq need
 * limbs < 2^53; an uncarried sub output can reach ~2^53.6). */
static void fe_sub(fe *h, const fe *f, const fe *g) {
    h->v[0] = f->v[0] + 0x1FFFFFFFFFFFB4ULL - g->v[0];
    h->v[1] = f->v[1] + 0x1FFFFFFFFFFFFCULL - g->v[1];
    h->v[2] = f->v[2] + 0x1FFFFFFFFFFFFCULL - g->v[2];
    h->v[3] = f->v[3] + 0x1FFFFFFFFFFFFCULL - g->v[3];
    h->v[4] = f->v[4] + 0x1FFFFFFFFFFFFCULL - g->v[4];
}

static void fe_carry(fe *h) {
    u64 c;
    c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
    c = h->v[1] >> 51; h->v[1] &= MASK51; h->v[2] += c;
    c = h->v[2] >> 51; h->v[2] &= MASK51; h->v[3] += c;
    c = h->v[3] >> 51; h->v[3] &= MASK51; h->v[4] += c;
    c = h->v[4] >> 51; h->v[4] &= MASK51; h->v[0] += c * 19;
    c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
}

static void fe_mul(fe *h, const fe *f, const fe *g) {
    u64 f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
    u64 g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3], g4 = g->v[4];
    u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;

    u128 t0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
              (u128)f3 * g2_19 + (u128)f4 * g1_19;
    u128 t1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
              (u128)f3 * g3_19 + (u128)f4 * g2_19;
    u128 t2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
              (u128)f3 * g4_19 + (u128)f4 * g3_19;
    u128 t3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
              (u128)f3 * g0 + (u128)f4 * g4_19;
    u128 t4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
              (u128)f3 * g1 + (u128)f4 * g0;

    u64 r0, r1, r2, r3, r4, c;
    t1 += (u64)(t0 >> 51); r0 = (u64)t0 & MASK51;
    t2 += (u64)(t1 >> 51); r1 = (u64)t1 & MASK51;
    t3 += (u64)(t2 >> 51); r2 = (u64)t2 & MASK51;
    t4 += (u64)(t3 >> 51); r3 = (u64)t3 & MASK51;
    c = (u64)(t4 >> 51);   r4 = (u64)t4 & MASK51;
    r0 += c * 19;
    r1 += r0 >> 51; r0 &= MASK51;
    h->v[0] = r0; h->v[1] = r1; h->v[2] = r2; h->v[3] = r3; h->v[4] = r4;
}

static void fe_sq(fe *h, const fe *f) {
    u64 f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
    u64 f0_2 = 2 * f0, f1_2 = 2 * f1;
    u64 f3_19 = 19 * f3, f4_19 = 19 * f4;

    u128 t0 = (u128)f0 * f0 + (u128)f1_2 * f4_19 + (u128)(2 * f2) * f3_19;
    u128 t1 = (u128)f0_2 * f1 + (u128)f2 * f4_19 * 2 + (u128)f3 * f3_19;
    u128 t2 = (u128)f0_2 * f2 + (u128)f1 * f1 + (u128)(2 * f3) * f4_19;
    u128 t3 = (u128)f0_2 * f3 + (u128)f1_2 * f2 + (u128)f4 * f4_19;
    u128 t4 = (u128)f0_2 * f4 + (u128)f1_2 * f3 + (u128)f2 * f2;

    u64 r0, r1, r2, r3, r4, c;
    t1 += (u64)(t0 >> 51); r0 = (u64)t0 & MASK51;
    t2 += (u64)(t1 >> 51); r1 = (u64)t1 & MASK51;
    t3 += (u64)(t2 >> 51); r2 = (u64)t2 & MASK51;
    t4 += (u64)(t3 >> 51); r3 = (u64)t3 & MASK51;
    c = (u64)(t4 >> 51);   r4 = (u64)t4 & MASK51;
    r0 += c * 19;
    r1 += r0 >> 51; r0 &= MASK51;
    h->v[0] = r0; h->v[1] = r1; h->v[2] = r2; h->v[3] = r3; h->v[4] = r4;
}

/* ignores bit 255 (sign bit handled by the caller); value may be >= p
 * (ZIP-215 rule 1: non-canonical y is reduced, not rejected) */
static void fe_frombytes(fe *h, const u8 s[32]) {
    u64 w0, w1, w2, w3;
    memcpy(&w0, s, 8); memcpy(&w1, s + 8, 8);
    memcpy(&w2, s + 16, 8); memcpy(&w3, s + 24, 8);
    h->v[0] = w0 & MASK51;
    h->v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
    h->v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
    h->v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
    h->v[4] = (w3 >> 12) & MASK51; /* drops bit 255 (the sign bit) */
}

/* canonical little-endian encoding (full reduction mod p, top bit clear) */
static void fe_tobytes(u8 s[32], const fe *f) {
    fe t = *f;
    fe_carry(&t);
    fe_carry(&t);
    /* limbs now < 2^51; conditionally subtract p */
    u64 q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    u64 c;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;
    u64 w0 = t.v[0] | (t.v[1] << 51);
    u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    memcpy(s, &w0, 8); memcpy(s + 8, &w1, 8);
    memcpy(s + 16, &w2, 8); memcpy(s + 24, &w3, 8);
}

static int fe_iszero(const fe *f) {
    u8 s[32];
    fe_tobytes(s, f);
    u8 acc = 0;
    for (int i = 0; i < 32; i++) acc |= s[i];
    return acc == 0;
}

static int fe_eq(const fe *f, const fe *g) {
    fe t;
    fe_sub(&t, f, g);
    return fe_iszero(&t);
}

static int fe_isodd(const fe *f) {
    u8 s[32];
    fe_tobytes(s, f);
    return s[0] & 1;
}

static void fe_neg(fe *h, const fe *f) {
    fe zero = {{0, 0, 0, 0, 0}};
    fe_sub(h, &zero, f);
    fe_carry(h);
}

/* f^(2^252 - 3)  ==  f^((p-5)/8): binary chain over 2^250-1 */
static void fe_pow2523(fe *out, const fe *z) {
    fe t0, t1, t2;
    int i;
    fe_sq(&t0, z);                                   /* 2 */
    fe_sq(&t1, &t0); fe_sq(&t1, &t1);                /* 8 */
    fe_mul(&t1, z, &t1);                             /* 9 */
    fe_mul(&t0, &t0, &t1);                           /* 11 */
    fe_sq(&t0, &t0);                                 /* 22 */
    fe_mul(&t0, &t1, &t0);                           /* 2^5-1 */
    fe_sq(&t1, &t0);
    for (i = 1; i < 5; i++) fe_sq(&t1, &t1);
    fe_mul(&t0, &t1, &t0);                           /* 2^10-1 */
    fe_sq(&t1, &t0);
    for (i = 1; i < 10; i++) fe_sq(&t1, &t1);
    fe_mul(&t1, &t1, &t0);                           /* 2^20-1 */
    fe_sq(&t2, &t1);
    for (i = 1; i < 20; i++) fe_sq(&t2, &t2);
    fe_mul(&t1, &t2, &t1);                           /* 2^40-1 */
    fe_sq(&t1, &t1);
    for (i = 1; i < 10; i++) fe_sq(&t1, &t1);
    fe_mul(&t0, &t1, &t0);                           /* 2^50-1 */
    fe_sq(&t1, &t0);
    for (i = 1; i < 50; i++) fe_sq(&t1, &t1);
    fe_mul(&t1, &t1, &t0);                           /* 2^100-1 */
    fe_sq(&t2, &t1);
    for (i = 1; i < 100; i++) fe_sq(&t2, &t2);
    fe_mul(&t1, &t2, &t1);                           /* 2^200-1 */
    fe_sq(&t1, &t1);
    for (i = 1; i < 50; i++) fe_sq(&t1, &t1);
    fe_mul(&t0, &t1, &t0);                           /* 2^250-1 */
    fe_sq(&t0, &t0); fe_sq(&t0, &t0);                /* 2^252-4 */
    fe_mul(out, &t0, z);                             /* 2^252-3 */
}

static const ge GE_ID = {{{0,0,0,0,0}}, {{1,0,0,0,0}}, {{1,0,0,0,0}}, {{0,0,0,0,0}}};

/* unified add-2008-hwcd-3 for a=-1: complete for all curve points
 * (including small-order), so bucket accumulation needs no special cases */
static void ge_add(ge *r, const ge *p, const ge *q) {
    fe A, B, C, D, E, F, G, H, t1, t2;
    fe_sub(&t1, &p->Y, &p->X);
    fe_sub(&t2, &q->Y, &q->X);
    fe_carry(&t1); fe_carry(&t2);
    fe_mul(&A, &t1, &t2);
    fe_add(&t1, &p->Y, &p->X);
    fe_add(&t2, &q->Y, &q->X);
    fe_mul(&B, &t1, &t2);
    fe_mul(&C, &p->T, &q->T);
    fe_mul(&C, &C, &FE_2D);
    fe_mul(&D, &p->Z, &q->Z);
    fe_add(&D, &D, &D);
    fe_sub(&E, &B, &A); fe_carry(&E);
    fe_sub(&F, &D, &C); fe_carry(&F);
    fe_add(&G, &D, &C);
    fe_add(&H, &B, &A);
    fe_mul(&r->X, &E, &F);
    fe_mul(&r->Y, &G, &H);
    fe_mul(&r->Z, &F, &G);
    fe_mul(&r->T, &E, &H);
}

/* dedicated doubling (dbl-2008-hwcd), 4M+4S */
static void ge_dbl(ge *r, const ge *p) {
    fe A, B, C, D, E, F, G, H, t;
    fe_sq(&A, &p->X);
    fe_sq(&B, &p->Y);
    fe_sq(&C, &p->Z);
    fe_add(&C, &C, &C);
    fe_neg(&D, &A);
    fe_add(&t, &p->X, &p->Y); fe_carry(&t);
    fe_sq(&t, &t);
    fe_sub(&t, &t, &A); fe_sub(&t, &t, &B); fe_carry(&t);
    E = t;
    fe_add(&G, &D, &B);
    fe_sub(&F, &G, &C); fe_carry(&F);
    fe_sub(&H, &D, &B); fe_carry(&H);
    fe_mul(&r->X, &E, &F);
    fe_mul(&r->Y, &G, &H);
    fe_mul(&r->Z, &F, &G);
    fe_mul(&r->T, &E, &H);
}

static void ge_neg(ge *r, const ge *p) {
    fe_neg(&r->X, &p->X);
    r->Y = p->Y;
    r->Z = p->Z;
    fe_neg(&r->T, &p->T);
}

/* ZIP-215 decompression, split so the fixed exponentiation can run
 * 8-wide on IFMA hosts (fe_ifma.c): phase A derives u, v, v3 and the
 * exponentiation input u*v^7; phase C finishes from pow = (u v^7)^((p-5)/8). */
typedef struct {
    fe u, v, v3, y, powin;
    int sign;
} dec_mid;

static void decompress_phase_a(dec_mid *d, const u8 s[32]) {
    fe t;
    d->sign = s[31] >> 7;
    fe_frombytes(&d->y, s);
    fe_sq(&d->u, &d->y);
    fe_mul(&d->v, &d->u, &FE_D);
    fe_sub(&d->u, &d->u, &FE_ONE); fe_carry(&d->u);   /* u = y^2 - 1 */
    fe_add(&d->v, &d->v, &FE_ONE);                    /* v = d y^2 + 1 */
    fe_sq(&d->v3, &d->v);
    fe_mul(&d->v3, &d->v3, &d->v);                    /* v^3 */
    fe_sq(&t, &d->v3);
    fe_mul(&t, &t, &d->v);
    fe_mul(&d->powin, &t, &d->u);                     /* u v^7 */
}

static int decompress_phase_c(ge *h, const dec_mid *d, const fe *pow) {
    fe x, vxx, check;
    fe_mul(&x, pow, &d->v3);
    fe_mul(&x, &x, &d->u);                 /* u v^3 (u v^7)^((p-5)/8) */
    fe_sq(&vxx, &x);
    fe_mul(&vxx, &vxx, &d->v);
    fe_sub(&check, &vxx, &d->u);
    if (!fe_iszero(&check)) {
        fe_add(&check, &vxx, &d->u);
        if (!fe_iszero(&check)) return 0;
        fe_mul(&x, &x, &FE_SQRTM1);
    }
    if (fe_iszero(&x)) {
        if (d->sign) return 0;             /* x=0 with sign bit set */
    } else if (fe_isodd(&x) != d->sign) {
        fe_neg(&x, &x);
    }
    h->X = x;
    h->Y = d->y;
    h->Z = FE_ONE;
    fe_mul(&h->T, &x, &d->y);
    return 1;
}

static int ge_frombytes_zip215(ge *h, const u8 s[32]) {
    dec_mid d;
    fe pow;
    decompress_phase_a(&d, s);
    fe_pow2523(&pow, &d.powin);
    return decompress_phase_c(h, &d, &pow);
}

/* radix-51 <-> radix-52 bridges for the IFMA lane layout */
static void fe_to52(const fe *f, u64 out[5]) {
    u8 b[32];
    u64 w[4];
    fe_tobytes(b, f);
    memcpy(w, b, 32);
    out[0] = w[0] & ((1ULL << 52) - 1);
    out[1] = ((w[0] >> 52) | (w[1] << 12)) & ((1ULL << 52) - 1);
    out[2] = ((w[1] >> 40) | (w[2] << 24)) & ((1ULL << 52) - 1);
    out[3] = ((w[2] >> 28) | (w[3] << 36)) & ((1ULL << 52) - 1);
    out[4] = w[3] >> 16;
}

static void fe_from52(const u64 in[5], fe *f) {
    u8 b[32];
    u64 w[4];
    /* limbs may be non-canonical (< 2^52); fold into 256-bit then load.
     * Total value < 2^256+eps... IFMA output limbs are < 2^52 so the
     * packed value fits 260 bits; fold the top 4 bits via 2^256 mod p:
     * simpler: combine as two 130-bit halves through fe arithmetic-free
     * byte packing requires full canonicality, so reduce with bigint-ish
     * carries first: value = sum in[k] 2^52k < 2^260; we use the fe
     * radix-51 loader on the low 255 bits and add the high part times
     * 2^255 mod p = 19. */
    u64 l[5] = {in[0], in[1], in[2], in[3], in[4]};
    /* pack low 255 bits */
    w[0] = l[0] | (l[1] << 52);
    w[1] = (l[1] >> 12) | (l[2] << 40);
    w[2] = (l[2] >> 24) | (l[3] << 28);
    w[3] = (l[3] >> 36) | (l[4] << 16);
    u64 top = l[4] >> 48; /* bits >= 2^256... wait: l4 weight 2^208 */
    memcpy(b, w, 32);
    b[31] &= 0x7F;
    u64 bit255 = (w[3] >> 63) & 1;
    fe_frombytes(f, b);
    /* add back bits 255.. : value_hi = top*2^256 + bit255*2^255
     * 2^255 == 19, 2^256 == 38 (mod p) */
    fe add = {{bit255 * 19 + top * 38, 0, 0, 0, 0}};
    fe_add(f, f, &add);
    fe_carry(f);
}

static int ge_is_identity(const ge *p) {
    return fe_iszero(&p->X) && fe_eq(&p->Y, &p->Z);
}

/* ---- exported API (ctypes) ---- */

/* fe_ifma.c: 8-wide x^((p-5)/8) on AVX-512 IFMA hosts */
extern void cmtpu_fe8_pow2523(const u64 *in, u64 *out);
extern int cmtpu_have_ifma(void);

/* Decompress pubkeys and R components, negated, for the batch equation.
 * pubs: n*32, sigs: n*64 (R||s).  Aneg/Rneg: n ge slots (opaque to Python).
 * ok[i] = 1 if both decompressed; NOT final validity — the s < L range
 * check runs in cmtpu_ed25519_scalar_prep, which clears ok[i] for
 * out-of-range s.  Returns the number of ok entries.
 *
 * On IFMA hosts the per-point sqrt exponentiation — the bulk of
 * decompression — runs 8 points per dispatch (4 signatures x {A, R}). */
long cmtpu_ed25519_precheck(long n, const u8 *pubs, const u8 *sigs,
                            ge *Aneg, ge *Rneg, u8 *ok) {
    static int have_ifma = -1;
    if (have_ifma < 0) have_ifma = cmtpu_have_ifma();
    long good = 0;
    if (!have_ifma) {
        for (long i = 0; i < n; i++) {
            ge A, R;
            if (ge_frombytes_zip215(&A, pubs + 32 * i) &&
                ge_frombytes_zip215(&R, sigs + 64 * i)) {
                ge_neg(&Aneg[i], &A);
                ge_neg(&Rneg[i], &R);
                ok[i] = 1;
                good++;
            } else {
                ok[i] = 0;
            }
        }
        return good;
    }
    for (long base = 0; base < n; base += 4) {
        long cnt = n - base < 4 ? n - base : 4;
        dec_mid mid[8];
        u64 lanes_in[40], lanes_out[40];
        memset(lanes_in, 0, sizeof lanes_in);
        for (long j = 0; j < cnt; j++) {
            decompress_phase_a(&mid[2 * j], pubs + 32 * (base + j));
            decompress_phase_a(&mid[2 * j + 1], sigs + 64 * (base + j));
            fe_to52(&mid[2 * j].powin, lanes_in + 5 * (2 * j));
            fe_to52(&mid[2 * j + 1].powin, lanes_in + 5 * (2 * j + 1));
        }
        cmtpu_fe8_pow2523(lanes_in, lanes_out);
        for (long j = 0; j < cnt; j++) {
            long i = base + j;
            fe powA, powR;
            ge A, R;
            fe_from52(lanes_out + 5 * (2 * j), &powA);
            fe_from52(lanes_out + 5 * (2 * j + 1), &powR);
            if (decompress_phase_c(&A, &mid[2 * j], &powA) &&
                decompress_phase_c(&R, &mid[2 * j + 1], &powR)) {
                ge_neg(&Aneg[i], &A);
                ge_neg(&Rneg[i], &R);
                ok[i] = 1;
                good++;
            } else {
                ok[i] = 0;
            }
        }
    }
    return good;
}

static int pick_window(long npoints) {
    if (npoints < 32) return 4;
    if (npoints < 128) return 5;
    if (npoints < 512) return 7;
    if (npoints < 2048) return 9;
    if (npoints < 8192) return 10;
    if (npoints < 32768) return 11;
    return 12;
}

static int get_digit(const u8 *sc, int pos, int c) {
    int byte = pos >> 3, shift = pos & 7;
    uint32_t v = sc[byte];
    if (byte + 1 < 32) v |= (uint32_t)sc[byte + 1] << 8;
    if (byte + 2 < 32) v |= (uint32_t)sc[byte + 2] << 16;
    return (v >> shift) & ((1 << c) - 1);
}

static ge BUCKETS[1 << 12];

/* Check  [8]( [ssum]B + sum [z_i]Rneg_i + sum [zh_i]Aneg_i ) == identity
 * over the m-entry subset idx of the prechecked points.
 * ssum: 32 bytes; z,zh: n*32 bytes (indexed by idx).  Returns 1 if holds. */
int cmtpu_ed25519_check_subset(const ge *Aneg, const ge *Rneg,
                               const int64_t *idx, long m,
                               const u8 *ssum, const u8 *z, const u8 *zh) {
    long npoints = 2 * m + 1;
    int c = pick_window(npoints);
    int nbuckets = (1 << c) - 1;
    int nwin = (253 + c - 1) / c;
    ge acc = GE_ID, Bp;
    Bp.X = FE_BX; Bp.Y = FE_BY; Bp.Z = FE_ONE;
    fe_mul(&Bp.T, &FE_BX, &FE_BY);

    for (int w = nwin - 1; w >= 0; w--) {
        if (w != nwin - 1)
            for (int k = 0; k < c; k++) ge_dbl(&acc, &acc);
        int pos = w * c;
        for (int b = 0; b < nbuckets; b++) BUCKETS[b] = GE_ID;
        int d = get_digit(ssum, pos, c);
        int used = 0;
        if (d) {
            ge_add(&BUCKETS[d - 1], &BUCKETS[d - 1], &Bp);
            used = 1;
        }
        for (long j = 0; j < m; j++) {
            long i = idx[j];
            d = get_digit(z + 32 * i, pos, c);
            if (d) { ge_add(&BUCKETS[d - 1], &BUCKETS[d - 1], &Rneg[i]); used = 1; }
            d = get_digit(zh + 32 * i, pos, c);
            if (d) { ge_add(&BUCKETS[d - 1], &BUCKETS[d - 1], &Aneg[i]); used = 1; }
        }
        if (!used) continue;
        ge run = GE_ID, wsum = GE_ID;
        for (int b = nbuckets - 1; b >= 0; b--) {
            ge_add(&run, &run, &BUCKETS[b]);
            ge_add(&wsum, &wsum, &run);
        }
        ge_add(&acc, &acc, &wsum);
    }
    ge_dbl(&acc, &acc);
    ge_dbl(&acc, &acc);
    ge_dbl(&acc, &acc);
    return ge_is_identity(&acc);
}

long cmtpu_ge_size(void) { return (long)sizeof(ge); }

/* ---- scalar arithmetic mod L (batch-equation coefficient prep) ----
 *
 * L = 2^252 + 27742317777372353535851937790883648493.  Values are 4x64-bit
 * little-endian limbs; products/reductions via unsigned __int128 and the
 * fold 2^252 == -C (mod L). */

static const u64 SC_L[4] = {
    0x5812631A5CF5D3EDULL, 0x14DEF9DEA2F79CD6ULL, 0, 0x1000000000000000ULL};
/* C = L - 2^252 (125 bits) */
static const u64 SC_C[2] = {0x5812631A5CF5D3EDULL, 0x14DEF9DEA2F79CD6ULL};

/* a[n] >> 252, into out[m] (caller sizes m for the true width) */
static void sc_shr252(const u64 *a, int n, u64 *out, int m) {
    for (int i = 0; i < m; i++) {
        u64 lo = (3 + i < n) ? (a[3 + i] >> 60) : 0;
        u64 hi = (4 + i < n) ? (a[4 + i] << 4) : 0;
        out[i] = lo | hi;
    }
}

/* out[4] = a & (2^252 - 1) */
static void sc_lo252(const u64 *a, int n, u64 out[4]) {
    for (int i = 0; i < 4; i++) out[i] = (i < n) ? a[i] : 0;
    out[3] &= (1ULL << 60) - 1;
}

/* out[n+2] = a[n] * C (C is 2 limbs) */
static void sc_mul_c(const u64 *a, int n, u64 *out) {
    for (int i = 0; i < n + 2; i++) out[i] = 0;
    for (int i = 0; i < n; i++) {
        u128 carry = 0;
        for (int j = 0; j < 2; j++) {
            u128 cur = (u128)out[i + j] + (u128)a[i] * SC_C[j] + carry;
            out[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        int k = i + 2;
        while (carry) {
            u128 cur = (u128)out[k] + carry;
            out[k] = (u64)cur;
            carry = cur >> 64;
            k++;
        }
    }
}

/* r (4 limbs) = x (8 limbs, < 2^512) mod L.
 *
 * Signed folding on 2^252 == -C (mod L), C = L - 2^252 (126 bits):
 *   x = plus - m_lo + m2_lo - m3          with
 *   m  = (x  >> 252) * C   (<= 386 bits)
 *   m2 = (m  >> 252) * C   (<= 260 bits)
 *   m3 = (m2 >> 252) * C   (<= 134 bits, already < 2^252)
 * so  x ≡ (plus + m2_lo) + 8L - (m_lo + m3)  with every term < 2^253,
 * then a bounded run of conditional subtracts normalizes into [0, L). */
static void sc_reduce512(u64 r[4], const u64 x[8]) {
    u64 plus[4], m[7], m_lo[4], m_hi[3], m2[5], m2_lo[4], m2_hi[1], m3[3];
    u64 hi[5];
    sc_lo252(x, 8, plus);
    sc_shr252(x, 8, hi, 5);          /* <= 260 bits */
    sc_mul_c(hi, 5, m);              /* <= 386 bits, 7 limbs */
    sc_lo252(m, 7, m_lo);
    sc_shr252(m, 7, m_hi, 3);        /* <= 134 bits */
    sc_mul_c(m_hi, 3, m2);           /* <= 260 bits, 5 limbs */
    sc_lo252(m2, 5, m2_lo);
    sc_shr252(m2, 5, m2_hi, 1);      /* <= 8 bits */
    sc_mul_c(m2_hi, 1, m3);          /* <= 134 bits, 3 limbs, < 2^252 */

    /* acc = plus + m2_lo + 8L - m_lo - m3, all in 5 limbs */
    u64 acc[5] = {0, 0, 0, 0, 0};
    u128 carry = 0;
    /* 8L = 2^255 + 8C */
    u64 eightl[5];
    eightl[0] = SC_C[0] << 3;
    eightl[1] = (SC_C[1] << 3) | (SC_C[0] >> 61);
    eightl[2] = SC_C[1] >> 61;
    eightl[3] = 1ULL << 63;
    eightl[4] = 0;
    for (int i = 0; i < 5; i++) {
        u128 t = carry + eightl[i];
        if (i < 4) t += (u128)plus[i] + m2_lo[i];
        acc[i] = (u64)t;
        carry = t >> 64;
    }
    /* single 5-limb subtrahend (m_lo + m3), then one borrow chain */
    u64 sub5[5] = {0, 0, 0, 0, 0};
    carry = 0;
    for (int i = 0; i < 5; i++) {
        u128 t = carry;
        if (i < 4) t += m_lo[i];
        if (i < 3) t += m3[i];
        sub5[i] = (u64)t;
        carry = t >> 64;
    }
    u64 borrow_bit = 0;
    for (int i = 0; i < 5; i++) {
        u128 t = (u128)acc[i] - sub5[i] - borrow_bit;
        acc[i] = (u64)t;
        borrow_bit = (t >> 64) ? 1 : 0;
    }
    /* acc < 8L + 2^253 < 11*L: bounded conditional subtracts */
    for (int rep = 0; rep < 12; rep++) {
        int ge_l;
        if (acc[4]) {
            ge_l = 1;
        } else {
            ge_l = 1;
            for (int i = 3; i >= 0; i--) {
                if (acc[i] > SC_L[i]) { ge_l = 1; break; }
                if (acc[i] < SC_L[i]) { ge_l = 0; break; }
            }
        }
        if (!ge_l) break;
        borrow_bit = 0;
        for (int i = 0; i < 5; i++) {
            u128 t = (u128)acc[i] - ((i < 4) ? SC_L[i] : 0) - borrow_bit;
            acc[i] = (u64)t;
            borrow_bit = (t >> 64) ? 1 : 0;
        }
    }
    r[0] = acc[0]; r[1] = acc[1]; r[2] = acc[2]; r[3] = acc[3];
}

static void sc_mul(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[i + j] + (u128)a[i] * b[j] + carry;
            t[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        t[i + 4] = (u64)carry;
    }
    sc_reduce512(r, t);
}

static void sc_add(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[8] = {0};
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] + b[i] + carry;
        t[i] = (u64)cur;
        carry = cur >> 64;
    }
    t[4] = (u64)carry;
    sc_reduce512(r, t);
}

/* s < L, strict (the RFC 8032 / ZIP-215 s-range check) */
static int sc_lt_l(const u64 s[4]) {
    for (int i = 3; i >= 0; i--) {
        if (s[i] < SC_L[i]) return 1;
        if (s[i] > SC_L[i]) return 0;
    }
    return 0; /* equal */
}

/* Batch scalar prep: for each entry i with ok[i] set on input (decompress
 * passed), check s < L (clearing ok[i] otherwise), compute
 *   h_i = digest_i mod L          (64-byte SHA-512 output)
 *   z_i = z16_i | 1               (forced odd, 128-bit)
 *   zh_i = z_i * h_i mod L
 * and accumulate ssum = sum z_i * s_i mod L over surviving entries.
 * Buffers are all little-endian; z32/zh32 are the MSM coefficient arrays. */
void cmtpu_ed25519_scalar_prep(long n, const u8 *digests, const u8 *sigs,
                               const u8 *z16, u8 *z32, u8 *zh32,
                               u8 *ssum32, u8 *ok) {
    u64 ssum[4] = {0, 0, 0, 0};
    for (long i = 0; i < n; i++) {
        if (!ok[i]) continue;
        u64 s[4];
        memcpy(s, sigs + 64 * i + 32, 32);
        if (!sc_lt_l(s)) { ok[i] = 0; continue; }
        u64 d[8], h[4], z[4] = {0, 0, 0, 0}, zh[4], zs[4];
        memcpy(d, digests + 64 * i, 64);
        sc_reduce512(h, d);
        memcpy(z, z16 + 16 * i, 16);
        z[0] |= 1;
        sc_mul(zh, z, h);
        sc_mul(zs, z, s);
        sc_add(ssum, ssum, zs);
        memcpy(z32 + 32 * i, z, 32);
        memcpy(zh32 + 32 * i, zh, 32);
    }
    memcpy(ssum32, ssum, 32);
}
