/* Native BLS12-381 point-decompression square roots.
 *
 * Role: the host half of signature deserialization
 * (crypto/bls/src/generic_signature.rs::deserialize -> blst's C/asm).
 * Pure-Python Fp2 square roots cost ~5 ms per signature — at 32k gossip
 * attestations that is minutes of host time per slot, so the sqrt runs
 * here: 6x64-bit Montgomery (CIOS) arithmetic, Fp2 towers, and the
 * p % 4 == 3 exponent-chain square root with the eighth-roots-of-unity
 * fixup (the same algorithm as crypto/ref_fields.py fp2_sqrt, which is
 * the cross-validated ground truth).
 *
 * Exposed (ctypes, all byte strings big-endian):
 *   int lh_g2_sqrt_rhs(const uint8_t x[96], uint8_t y[96]);
 *     x = x0 || x1; on success writes y = y0 || y1 with
 *     y^2 == x^3 + 4(1+u) and returns 1; returns 0 if x is not on the
 *     curve.
 *   int lh_g1_sqrt_rhs(const uint8_t x[48], uint8_t y[48]);
 *     same for G1 (y^2 == x^3 + 4).
 *
 * Canonicality (x < p) is checked by the Python caller, which also owns
 * the wire flags (infinity/sort) and the lexicographic y selection.
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t fp[6];

static const fp P_ = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
};
static const uint64_t N0 = 0x89f3fffcfffcfffdULL; /* -p^-1 mod 2^64 */
static const fp R2 = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL,
};
static const fp ONE_M = { /* R mod p */
    0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL,
    0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL,
};
static const fp NEG_HALF = { /* (-1/2) mod p, canonical */
    0xdcff7fffffffd555ULL, 0x0f55ffff58a9ffffULL, 0xb39869507b587b12ULL,
    0xb23ba5c279c2895fULL, 0x258dd3db21a5d66bULL, 0x0d0088f51cbff34dULL,
};
/* (p^2 + 7) / 16, big-endian (95 bytes) */
static const uint8_t EXP16[95] = {
    0x2a,0x43,0x7a,0x4b,0x8c,0x35,0xfc,0x74,0xbd,0x27,0x8e,0xaa,0x22,
    0xf2,0x5e,0x9e,0x2d,0xc9,0x0e,0x50,0xe7,0x04,0x6b,0x46,0x6e,0x59,
    0xe4,0x93,0x49,0xe8,0xbd,0x05,0x0a,0x62,0xcf,0xd1,0x6d,0xdc,0xa6,
    0xef,0x53,0x14,0x93,0x30,0x97,0x8e,0xf0,0x11,0xd6,0x86,0x19,0xc8,
    0x61,0x85,0xc7,0xb2,0x92,0xe8,0x5a,0x87,0x09,0x1a,0x04,0x96,0x6b,
    0xf9,0x1e,0xd3,0xe7,0x1b,0x74,0x31,0x62,0xc3,0x38,0x36,0x21,0x13,
    0xcf,0xd7,0xce,0xd6,0xb1,0xd7,0x63,0x82,0xea,0xb2,0x6a,0xa0,0x00,
    0x01,0xc7,0x18,0xe4,
};
/* (p + 1) / 4, big-endian (48 bytes) */
static const uint8_t EXP_P14[48] = {
    0x06,0x80,0x44,0x7a,0x8e,0x5f,0xf9,0xa6,0x92,0xc6,0xe9,0xed,0x90,
    0xd2,0xeb,0x35,0xd9,0x1d,0xd2,0xe1,0x3c,0xe1,0x44,0xaf,0xd9,0xcc,
    0x34,0xa8,0x3d,0xac,0x3d,0x89,0x07,0xaa,0xff,0xff,0xac,0x54,0xff,
    0xff,0xee,0x7f,0xbf,0xff,0xff,0xff,0xea,0xab,
};

/* ------------------------------------------------------------------ fp */

static void fp_copy(fp r, const fp a) { memcpy(r, a, sizeof(fp)); }
static void fp_zero(fp r) { memset(r, 0, sizeof(fp)); }

static int fp_is_zero(const fp a) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a[i];
    return acc == 0;
}

static int fp_eq(const fp a, const fp b) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a[i] ^ b[i];
    return acc == 0;
}

/* r = a + b mod p (inputs canonical) */
static void fp_add(fp r, const fp a, const fp b) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
        c += (u128)a[i] + b[i];
        r[i] = (uint64_t)c;
        c >>= 64;
    }
    /* conditional subtract p */
    fp t;
    u128 br = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)r[i] - P_[i] - (uint64_t)br;
        t[i] = (uint64_t)d;
        br = (d >> 64) & 1; /* borrow flag */
    }
    if (c || !br) fp_copy(r, t);
}

/* r = a - b mod p */
static void fp_sub(fp r, const fp a, const fp b) {
    u128 br = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - b[i] - (uint64_t)br;
        r[i] = (uint64_t)d;
        br = (d >> 64) & 1;
    }
    if (br) {
        u128 c = 0;
        for (int i = 0; i < 6; i++) {
            c += (u128)r[i] + P_[i];
            r[i] = (uint64_t)c;
            c >>= 64;
        }
    }
}

static void fp_neg(fp r, const fp a) {
    if (fp_is_zero(a)) { fp_zero(r); return; }
    fp z; fp_zero(z);
    fp_sub(r, z, a);
}

/* CIOS Montgomery multiplication: r = a*b*R^-1 mod p */
static void fp_mont_mul(fp r, const fp a, const fp b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 c = 0;
        for (int j = 0; j < 6; j++) {
            c += (u128)t[j] + (u128)a[i] * b[j];
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[6];
        t[6] = (uint64_t)c;
        t[7] = (uint64_t)(c >> 64);

        uint64_t m = t[0] * N0;
        c = (u128)t[0] + (u128)m * P_[0];
        c >>= 64;
        for (int j = 1; j < 6; j++) {
            c += (u128)t[j] + (u128)m * P_[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[6];
        t[5] = (uint64_t)c;
        t[6] = t[7] + (uint64_t)(c >> 64);
        t[7] = 0;
    }
    /* t[0..6] holds the result (< 2p); conditional subtract */
    fp out;
    memcpy(out, t, sizeof(fp));
    u128 br = 0;
    fp s;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)out[i] - P_[i] - (uint64_t)br;
        s[i] = (uint64_t)d;
        br = (d >> 64) & 1;
    }
    if (t[6] || !br) fp_copy(r, s); else fp_copy(r, out);
}

static void fp_to_mont(fp r, const fp a) { fp_mont_mul(r, a, R2); }
static void fp_from_mont(fp r, const fp a) {
    fp one; fp_zero(one); one[0] = 1;
    fp_mont_mul(r, a, one);
}

/* Montgomery pow with big-endian byte exponent */
static void fp_pow_be(fp r, const fp base, const uint8_t *e, int elen) {
    fp acc; fp_copy(acc, ONE_M);
    for (int i = 0; i < elen; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            fp_mont_mul(acc, acc, acc);
            if ((e[i] >> bit) & 1) fp_mont_mul(acc, acc, base);
        }
    }
    fp_copy(r, acc);
}

/* ----------------------------------------------------------------- fp2 */

typedef struct { fp c0, c1; } fp2;

static void fp2_copy(fp2 *r, const fp2 *a) { *r = *a; }

static int fp2_is_zero(const fp2 *a) {
    return fp_is_zero(a->c0) && fp_is_zero(a->c1);
}

static int fp2_eq(const fp2 *a, const fp2 *b) {
    return fp_eq(a->c0, b->c0) && fp_eq(a->c1, b->c1);
}

static void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_add(r->c0, a->c0, b->c0);
    fp_add(r->c1, a->c1, b->c1);
}

/* Karatsuba: (a0 + a1 u)(b0 + b1 u) with 3 base multiplications */
static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
    fp t0, t1, sa, sb, cross;
    fp_mont_mul(t0, a->c0, b->c0);
    fp_mont_mul(t1, a->c1, b->c1);
    fp_add(sa, a->c0, a->c1);
    fp_add(sb, b->c0, b->c1);
    fp_mont_mul(cross, sa, sb);
    fp_sub(cross, cross, t0);
    fp_sub(cross, cross, t1);
    fp2 out;
    fp_sub(out.c0, t0, t1);
    fp_copy(out.c1, cross);
    *r = out;
}

static void fp2_sqr(fp2 *r, const fp2 *a) { fp2_mul(r, a, a); }

static void fp2_pow_be(fp2 *r, const fp2 *base, const uint8_t *e,
                       int elen) {
    fp2 acc;
    fp_copy(acc.c0, ONE_M);
    fp_zero(acc.c1);
    for (int i = 0; i < elen; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            fp2_sqr(&acc, &acc);
            if ((e[i] >> bit) & 1) fp2_mul(&acc, &acc, base);
        }
    }
    *r = acc;
}

/* eighth roots of unity (Montgomery), built once */
static fp2 EIGHTH[8];
static int INIT_DONE = 0;

static void init_roots(void) {
    if (INIT_DONE) return;
    fp2 u; /* (0, 1) in Montgomery */
    fp_zero(u.c0);
    fp_copy(u.c1, ONE_M);
    fp_copy(EIGHTH[0].c0, ONE_M);
    fp_zero(EIGHTH[0].c1);
    for (int i = 1; i < 4; i++) fp2_mul(&EIGHTH[i], &EIGHTH[i - 1], &u);
    /* sqrt(u) = (a, -a) with a = (-1/2)^((p+1)/4) */
    fp nh_m, a;
    fp_to_mont(nh_m, NEG_HALF);
    fp_pow_be(a, nh_m, EXP_P14, 48);
    fp2 eighth;
    fp_copy(eighth.c0, a);
    fp_neg(eighth.c1, a);
    for (int i = 0; i < 4; i++)
        fp2_mul(&EIGHTH[i + 4], &EIGHTH[i], &eighth);
    INIT_DONE = 1;
}

/* sqrt in Fp2 (p % 4 == 3 method); 1 on success */
static int fp2_sqrt(fp2 *out, const fp2 *a) {
    if (fp2_is_zero(a)) {
        fp_zero(out->c0);
        fp_zero(out->c1);
        return 1;
    }
    init_roots();
    fp2 cand;
    fp2_pow_be(&cand, a, EXP16, 95);
    for (int i = 0; i < 8; i++) {
        fp2 r, r2;
        fp2_mul(&r, &cand, &EIGHTH[i]);
        fp2_sqr(&r2, &r);
        if (fp2_eq(&r2, a)) {
            fp2_copy(out, &r);
            return 1;
        }
    }
    return 0;
}

/* ------------------------------------------------- subgroup checks
 *
 * [r]P == infinity via an MSB-first Jacobian double-and-add with a
 * mixed (affine-base) addition that handles the exceptional cases
 * (infinity accumulator, doubling collision, inverse annihilation) —
 * the inputs are on-curve but deliberately NOT assumed to be in the
 * r-torsion. Generic over Fp / Fp2 via macros.
 */

/* group order r, big-endian */
static const uint8_t R_BE[32] = {
    0x73,0xed,0xa7,0x53,0x29,0x9d,0x7d,0x48,0x33,0x39,0xd8,0x08,0x09,
    0xa1,0xd8,0x05,0x53,0xbd,0xa4,0x02,0xff,0xfe,0x5b,0xfe,0xff,0xff,
    0xff,0xff,0x00,0x00,0x00,0x01,
};

#define DEF_JAC(F, fe, fe_mul, fe_sqr_, fe_add_, fe_sub_, fe_is_zero_, \
                fe_eq_, fe_copy_, fe_zero_, fe_dbl_)                   \
    typedef struct { fe X, Y, Z; } jac_##F;                            \
    static void F##_jac_double(jac_##F *r, const jac_##F *p) {         \
        if (fe_is_zero_(&p->Z)) { *r = *p; return; }                   \
        fe A, B, C, D, E, Fv, t;                                       \
        fe_sqr_(&A, &p->X);                                            \
        fe_sqr_(&B, &p->Y);                                            \
        fe_sqr_(&C, &B);                                               \
        fe_add_(&t, &p->X, &B);                                        \
        fe_sqr_(&t, &t);                                               \
        fe_sub_(&t, &t, &A);                                           \
        fe_sub_(&t, &t, &C);                                           \
        fe_dbl_(&D, &t);                                               \
        fe_add_(&E, &A, &A);                                           \
        fe_add_(&E, &E, &A);                                           \
        fe_sqr_(&Fv, &E);                                              \
        jac_##F out;                                                   \
        fe_sub_(&out.X, &Fv, &D);                                      \
        fe_sub_(&out.X, &out.X, &D);                                   \
        fe_sub_(&t, &D, &out.X);                                       \
        fe_mul(&t, &E, &t);                                            \
        fe C8;                                                         \
        fe_dbl_(&C8, &C); fe_dbl_(&C8, &C8); fe_dbl_(&C8, &C8);        \
        fe_sub_(&out.Y, &t, &C8);                                      \
        fe_mul(&out.Z, &p->Y, &p->Z);                                  \
        fe_dbl_(&out.Z, &out.Z);                                       \
        *r = out;                                                      \
    }                                                                  \
    /* mixed add: q affine (x2, y2); full exceptional handling */      \
    static void F##_jac_add_affine(jac_##F *r, const jac_##F *p,       \
                                   const fe *x2, const fe *y2) {       \
        if (fe_is_zero_(&p->Z)) {                                      \
            fe_copy_(&r->X, x2);                                       \
            fe_copy_(&r->Y, y2);                                       \
            fe_zero_(&r->Z);                                           \
            /* Z = 1 in Montgomery */                                  \
            F##_set_one(&r->Z);                                        \
            return;                                                    \
        }                                                              \
        fe Z1Z1, U2, S2, H, HH, I, J, rr, V, t;                        \
        fe_sqr_(&Z1Z1, &p->Z);                                         \
        fe_mul(&U2, x2, &Z1Z1);                                        \
        fe_mul(&S2, y2, &Z1Z1);                                        \
        fe_mul(&S2, &S2, &p->Z);                                       \
        fe_sub_(&H, &U2, &p->X);                                       \
        fe_sub_(&rr, &S2, &p->Y);                                      \
        if (fe_is_zero_(&H)) {                                         \
            if (fe_is_zero_(&rr)) { F##_jac_double(r, p); return; }    \
            fe_zero_(&r->X); fe_zero_(&r->Y); fe_zero_(&r->Z);         \
            F##_set_one(&r->Y); /* canonical infinity (0,1,0) */       \
            return;                                                    \
        }                                                              \
        fe_dbl_(&t, &H);                                               \
        fe_sqr_(&I, &t);                                               \
        fe_mul(&J, &H, &I);                                            \
        fe_dbl_(&rr, &rr);                                             \
        fe_mul(&V, &p->X, &I);                                         \
        jac_##F out;                                                   \
        fe_sqr_(&out.X, &rr);                                          \
        fe_sub_(&out.X, &out.X, &J);                                   \
        fe_sub_(&out.X, &out.X, &V);                                   \
        fe_sub_(&out.X, &out.X, &V);                                   \
        fe_sub_(&t, &V, &out.X);                                       \
        fe_mul(&t, &rr, &t);                                           \
        fe S1J;                                                        \
        fe_mul(&S1J, &p->Y, &J);                                       \
        fe_dbl_(&S1J, &S1J);                                           \
        fe_sub_(&out.Y, &t, &S1J);                                     \
        fe_mul(&out.Z, &p->Z, &H);                                     \
        fe_dbl_(&out.Z, &out.Z);                                       \
        *r = out;                                                      \
    }                                                                  \
    static int F##_in_subgroup(const fe *x, const fe *y) {             \
        jac_##F acc;                                                   \
        fe_zero_(&acc.X); fe_zero_(&acc.Y); fe_zero_(&acc.Z);          \
        F##_set_one(&acc.Y);                                           \
        for (int i = 0; i < 32; i++)                                   \
            for (int bit = 7; bit >= 0; bit--) {                       \
                F##_jac_double(&acc, &acc);                            \
                if ((R_BE[i] >> bit) & 1)                              \
                    F##_jac_add_affine(&acc, &acc, x, y);              \
            }                                                          \
        return fe_is_zero_(&acc.Z);                                    \
    }

/* fe = fp wrappers (pointer-style) */
typedef struct { fp v; } fe1;
static void fe1_mul(fe1 *r, const fe1 *a, const fe1 *b) {
    fp_mont_mul(r->v, a->v, b->v);
}
static void fe1_sqr(fe1 *r, const fe1 *a) { fp_mont_mul(r->v, a->v, a->v); }
static void fe1_add_(fe1 *r, const fe1 *a, const fe1 *b) {
    fp_add(r->v, a->v, b->v);
}
static void fe1_sub_(fe1 *r, const fe1 *a, const fe1 *b) {
    fp_sub(r->v, a->v, b->v);
}
static int fe1_is_zero(const fe1 *a) { return fp_is_zero(a->v); }
static int fe1_eq(const fe1 *a, const fe1 *b) { return fp_eq(a->v, b->v); }
static void fe1_copy(fe1 *r, const fe1 *a) { fp_copy(r->v, a->v); }
static void fe1_zero(fe1 *r) { fp_zero(r->v); }
static void fe1_dbl(fe1 *r, const fe1 *a) { fp_add(r->v, a->v, a->v); }
static void g1f_set_one(fe1 *r) { fp_copy(r->v, ONE_M); }
#define g1f_unused
DEF_JAC(g1f, fe1, fe1_mul, fe1_sqr, fe1_add_, fe1_sub_, fe1_is_zero,
        fe1_eq, fe1_copy, fe1_zero, fe1_dbl)

/* fe = fp2 wrappers */
static void fe2_mul(fp2 *r, const fp2 *a, const fp2 *b) { fp2_mul(r, a, b); }
static void fe2_sqr(fp2 *r, const fp2 *a) { fp2_sqr(r, a); }
static void fe2_add_(fp2 *r, const fp2 *a, const fp2 *b) { fp2_add(r, a, b); }
static void fe2_sub_(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_sub(r->c0, a->c0, b->c0);
    fp_sub(r->c1, a->c1, b->c1);
}
static int fe2_is_zero(const fp2 *a) { return fp2_is_zero(a); }
static void fe2_copy(fp2 *r, const fp2 *a) { *r = *a; }
static void fe2_zero(fp2 *r) { fp_zero(r->c0); fp_zero(r->c1); }
static void fe2_dbl(fp2 *r, const fp2 *a) { fe2_add_(r, a, a); }
static void g2f_set_one(fp2 *r) { fp_copy(r->c0, ONE_M); fp_zero(r->c1); }
DEF_JAC(g2f, fp2, fe2_mul, fe2_sqr, fe2_add_, fe2_sub_, fe2_is_zero,
        fp2_eq, fe2_copy, fe2_zero, fe2_dbl)

/* ------------------------------------------------------------- binding */

static void be_to_fp(fp r, const uint8_t *b) {
    for (int i = 0; i < 6; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++)
            v = (v << 8) | b[(5 - i) * 8 + j];
        r[i] = v;
    }
}

static void fp_to_be(uint8_t *b, const fp a) {
    for (int i = 0; i < 6; i++) {
        uint64_t v = a[i];
        for (int j = 7; j >= 0; j--) {
            b[(5 - i) * 8 + j] = (uint8_t)v;
            v >>= 8;
        }
    }
}

/* y^2 = x^3 + 4(1+u); x,y are x0||x1 / y0||y1 big-endian */
int lh_g2_sqrt_rhs(const uint8_t *x_be, uint8_t *y_be) {
    fp2 x, rhs, y;
    be_to_fp(x.c0, x_be);
    be_to_fp(x.c1, x_be + 48);
    fp_to_mont(x.c0, x.c0);
    fp_to_mont(x.c1, x.c1);
    fp2_sqr(&rhs, &x);
    fp2_mul(&rhs, &rhs, &x);
    /* B = 4 + 4u in Montgomery: 4*ONE_M componentwise */
    fp2 b;
    fp_add(b.c0, ONE_M, ONE_M);
    fp_add(b.c0, b.c0, b.c0);
    fp_copy(b.c1, b.c0);
    fp2_add(&rhs, &rhs, &b);
    if (!fp2_sqrt(&y, &rhs)) return 0;
    fp_from_mont(y.c0, y.c0);
    fp_from_mont(y.c1, y.c1);
    fp_to_be(y_be, y.c0);
    fp_to_be(y_be + 48, y.c1);
    return 1;
}

/* [r]P == inf for affine (x, y) in G1; bytes big-endian, canonical */
int lh_g1_in_subgroup(const uint8_t *x_be, const uint8_t *y_be) {
    fe1 x, y;
    be_to_fp(x.v, x_be);
    be_to_fp(y.v, y_be);
    fp_to_mont(x.v, x.v);
    fp_to_mont(y.v, y.v);
    return g1f_in_subgroup(&x, &y);
}

/* [r]P == inf for affine G2 (x0||x1||y0||y1, 192 bytes big-endian) */
int lh_g2_in_subgroup(const uint8_t *xy_be) {
    fp2 x, y;
    be_to_fp(x.c0, xy_be);
    be_to_fp(x.c1, xy_be + 48);
    be_to_fp(y.c0, xy_be + 96);
    be_to_fp(y.c1, xy_be + 144);
    fp_to_mont(x.c0, x.c0);
    fp_to_mont(x.c1, x.c1);
    fp_to_mont(y.c0, y.c0);
    fp_to_mont(y.c1, y.c1);
    return g2f_in_subgroup(&x, &y);
}

/* y^2 = x^3 + 4 over Fp */
int lh_g1_sqrt_rhs(const uint8_t *x_be, uint8_t *y_be) {
    fp x, rhs, y, y2, b;
    be_to_fp(x, x_be);
    fp_to_mont(x, x);
    fp_mont_mul(rhs, x, x);
    fp_mont_mul(rhs, rhs, x);
    fp_add(b, ONE_M, ONE_M);
    fp_add(b, b, b);
    fp_add(rhs, rhs, b);
    fp_pow_be(y, rhs, EXP_P14, 48);
    fp_mont_mul(y2, y, y);
    if (!fp_eq(y2, rhs)) return 0;
    fp_from_mont(y, y);
    fp_to_be(y_be, y);
    return 1;
}
