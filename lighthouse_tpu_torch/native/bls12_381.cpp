// bls12_381.cpp — native CPU BLS12-381 backend for lighthouse_tpu_torch, a
// copy of lighthouse_tpu/native/bls12_381.cpp (pinned byte-equal in its
// outputs by tests/test_torch_native_bls.py).
//
// The framework's CPU parity backend: the role blst plays for Lighthouse
// (crypto/bls/src/impls/blst.rs:37-119 verify_multiple_aggregate_signatures;
// sign/verify at blst.rs:172-283). Algorithms mirror the pure-Python oracle
// (lighthouse_tpu_torch/oracle/*) — same tower (Fq2 = Fq[u]/(u^2+1),
// Fq6 = Fq2[v]/(v^3-(u+1)), Fq12 = Fq6[w]/(w^2-v)), same CLN projective
// Miller loop + mul_by_014 sparse folding as the device kernels
// (lighthouse_tpu_torch/ops/bls/pairing.py), same x-chain final exponentiation.
//
// Arithmetic: 6x64-bit limbs, Montgomery form, CIOS multiplication via
// unsigned __int128. Single translation unit; built by native/build.py with
// g++ -O3 -shared. Derived constants (R^2, Montgomery inverse, Frobenius and
// psi coefficients) are computed at init from the modulus rather than
// hardcoded, so a limb typo cannot silently corrupt them.

#include <cstdint>
#include <cstring>
#include <cstdlib>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// Fp: 6x64 limbs, little-endian, Montgomery form
// ---------------------------------------------------------------------------

static const u64 P_LIMBS[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};

// Subgroup order r (scalar field), little-endian.
static const u64 R_LIMBS[4] = {
    0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
    0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

static const u64 BLS_X_ABS = 0xd201000000010000ULL;  // |x|; x is negative

struct Fp {
  u64 l[6];
};

static u64 MONT_INV;  // -p^{-1} mod 2^64
static Fp R2;         // 2^768 mod p (Montgomery conversion factor)
static Fp FP_ONE;     // 2^384 mod p (1 in Montgomery form)
static const Fp FP_ZERO = {{0, 0, 0, 0, 0, 0}};

static inline int fp_cmp_raw(const u64 a[6], const u64 b[6]) {
  for (int i = 5; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static inline void fp_add(Fp &o, const Fp &a, const Fp &b) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (u128)a.l[i] + b.l[i];
    o.l[i] = (u64)c;
    c >>= 64;
  }
  if (c || fp_cmp_raw(o.l, P_LIMBS) >= 0) {
    u128 br = 0;
    for (int i = 0; i < 6; i++) {
      u128 d = (u128)o.l[i] - P_LIMBS[i] - (u64)br;
      o.l[i] = (u64)d;
      br = (d >> 64) ? 1 : 0;
    }
  }
}

static inline void fp_sub(Fp &o, const Fp &a, const Fp &b) {
  u128 br = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.l[i] - b.l[i] - (u64)br;
    o.l[i] = (u64)d;
    br = (d >> 64) ? 1 : 0;
  }
  if (br) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (u128)o.l[i] + P_LIMBS[i];
      o.l[i] = (u64)c;
      c >>= 64;
    }
  }
}

static inline void fp_neg(Fp &o, const Fp &a) {
  if (fp_cmp_raw(a.l, FP_ZERO.l) == 0) {
    o = FP_ZERO;
    return;
  }
  u128 br = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)P_LIMBS[i] - a.l[i] - (u64)br;
    o.l[i] = (u64)d;
    br = (d >> 64) ? 1 : 0;
  }
}

static inline void fp_dbl(Fp &o, const Fp &a) { fp_add(o, a, a); }

// CIOS Montgomery multiplication: o = a*b*2^-384 mod p.
static void fp_mul(Fp &o, const Fp &a, const Fp &b) {
  u64 t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) {
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      c = (u128)a.l[j] * b.l[i] + t[j] + (u64)c;
      t[j] = (u64)c;
      c >>= 64;
    }
    u128 s = (u128)t[6] + (u64)c;
    t[6] = (u64)s;
    t[7] = (u64)(s >> 64);

    u64 m = t[0] * MONT_INV;
    c = (u128)m * P_LIMBS[0] + t[0];
    c >>= 64;
    for (int j = 1; j < 6; j++) {
      c = (u128)m * P_LIMBS[j] + t[j] + (u64)c;
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    s = (u128)t[6] + (u64)c;
    t[5] = (u64)s;
    t[6] = t[7] + (u64)(s >> 64);
    t[7] = 0;
  }
  if (t[6] || fp_cmp_raw(t, P_LIMBS) >= 0) {
    u128 br = 0;
    for (int i = 0; i < 6; i++) {
      u128 d = (u128)t[i] - P_LIMBS[i] - (u64)br;
      t[i] = (u64)d;
      br = (d >> 64) ? 1 : 0;
    }
  }
  memcpy(o.l, t, 48);
}

static inline void fp_sqr(Fp &o, const Fp &a) { fp_mul(o, a, a); }

static inline bool fp_is_zero(const Fp &a) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.l[i];
  return acc == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
  return memcmp(a.l, b.l, 48) == 0;
}

static void fp_to_mont(Fp &o, const Fp &a) { fp_mul(o, a, R2); }

static void fp_from_mont(Fp &o, const Fp &a) {
  Fp one_raw = {{1, 0, 0, 0, 0, 0}};
  fp_mul(o, a, one_raw);
}

// MSB-first square-and-multiply; exponent is nbits bits of e (little-endian limbs).
static void fp_pow(Fp &o, const Fp &base, const u64 *e, int nbits) {
  Fp r = FP_ONE;
  for (int i = nbits - 1; i >= 0; i--) {
    fp_sqr(r, r);
    if ((e[i / 64] >> (i % 64)) & 1) fp_mul(r, r, base);
  }
  o = r;
}

static u64 EXP_P_MINUS_2[6];   // p-2          (Fp inverse)
static u64 EXP_P_PLUS_1_D4[6]; // (p+1)/4      (Fp sqrt)
static u64 EXP_P_MINUS_3_D4[6]; // (p-3)/4     (Fq2 sqrt)
static u64 EXP_P_MINUS_1_D2[6]; // (p-1)/2     (Fq2 sqrt aux / psi_y exponent)
static u64 EXP_P_MINUS_1_D3[6]; // (p-1)/3     (frobenius / psi_x exponent)
static u64 EXP_P_MINUS_1_D6[6]; // (p-1)/6     (frobenius w coefficient)

static void fp_inv(Fp &o, const Fp &a) { fp_pow(o, a, EXP_P_MINUS_2, 381); }

// sqrt in Fp (p = 3 mod 4): a^((p+1)/4); returns false if not a QR.
static bool fp_sqrt(Fp &o, const Fp &a) {
  Fp c, c2;
  fp_pow(c, a, EXP_P_PLUS_1_D4, 380);
  fp_sqr(c2, c);
  if (!fp_eq(c2, a)) return false;
  o = c;
  return true;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)
// ---------------------------------------------------------------------------

struct Fp2 {
  Fp c0, c1;
};

static Fp2 FP2_ZERO, FP2_ONE;

static inline void fp2_add(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}
static inline void fp2_sub(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}
static inline void fp2_neg(Fp2 &o, const Fp2 &a) {
  fp_neg(o.c0, a.c0);
  fp_neg(o.c1, a.c1);
}
static inline void fp2_dbl(Fp2 &o, const Fp2 &a) { fp2_add(o, a, a); }

static void fp2_mul(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  Fp t0, t1, s0, s1, m;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(m, s0, s1);
  fp_sub(o.c0, t0, t1);
  fp_sub(m, m, t0);
  fp_sub(o.c1, m, t1);
}

static void fp2_sqr(Fp2 &o, const Fp2 &a) {
  Fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(o.c0, s, d);
  fp_dbl(o.c1, m);
}

static inline void fp2_conj(Fp2 &o, const Fp2 &a) {
  o.c0 = a.c0;
  fp_neg(o.c1, a.c1);
}

// multiply by the Fq6 non-residue (u+1)
static inline void fp2_mul_nr(Fp2 &o, const Fp2 &a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  o.c0 = t0;
  o.c1 = t1;
}

static inline void fp2_mul_fp(Fp2 &o, const Fp2 &a, const Fp &s) {
  fp_mul(o.c0, a.c0, s);
  fp_mul(o.c1, a.c1, s);
}

static void fp2_inv(Fp2 &o, const Fp2 &a) {
  Fp t0, t1, t;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(t, t0, t1);
  fp_inv(t, t);
  fp_mul(o.c0, a.c0, t);
  fp_mul(t, a.c1, t);
  fp_neg(o.c1, t);
}

static inline bool fp2_is_zero(const Fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool fp2_eq(const Fp2 &a, const Fp2 &b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

static void fp2_pow(Fp2 &o, const Fp2 &base, const u64 *e, int nbits) {
  Fp2 r = FP2_ONE;
  for (int i = nbits - 1; i >= 0; i--) {
    fp2_sqr(r, r);
    if ((e[i / 64] >> (i % 64)) & 1) fp2_mul(r, r, base);
  }
  o = r;
}

// sqrt in Fp2 (p = 3 mod 4 complex method; oracle fields.py:104-118).
static bool fp2_sqrt(Fp2 &o, const Fp2 &a) {
  if (fp2_is_zero(a)) {
    o = FP2_ZERO;
    return true;
  }
  Fp2 a1, x0, alpha, cand, chk;
  fp2_pow(a1, a, EXP_P_MINUS_3_D4, 379);
  fp2_mul(x0, a1, a);
  fp2_mul(alpha, a1, x0);
  Fp2 minus_one;
  fp2_neg(minus_one, FP2_ONE);
  if (fp2_eq(alpha, minus_one)) {
    // cand = u * x0
    fp_neg(cand.c0, x0.c1);
    cand.c1 = x0.c0;
  } else {
    Fp2 b;
    fp2_add(b, alpha, FP2_ONE);
    fp2_pow(b, b, EXP_P_MINUS_1_D2, 380);
    fp2_mul(cand, b, x0);
  }
  fp2_sqr(chk, cand);
  if (!fp2_eq(chk, a)) return false;
  o = cand;
  return true;
}

// RFC 9380 sgn0 for Fp2 (canonical form parity).
static int fp2_sgn0(const Fp2 &a) {
  Fp c0, c1;
  fp_from_mont(c0, a.c0);
  fp_from_mont(c1, a.c1);
  int s0 = (int)(c0.l[0] & 1);
  int z0 = fp_is_zero(c0) ? 1 : 0;
  int s1 = (int)(c1.l[0] & 1);
  return s0 | (z0 & s1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - (u+1))
// ---------------------------------------------------------------------------

struct Fp6 {
  Fp2 c0, c1, c2;
};

static Fp6 FP6_ZERO, FP6_ONE;
static Fp2 FROB6_C1[6], FROB6_C2[6];  // power-k coefficients, k in 0..5
static Fp2 FROB12_C1[12];

static inline void fp6_add(Fp6 &o, const Fp6 &a, const Fp6 &b) {
  fp2_add(o.c0, a.c0, b.c0);
  fp2_add(o.c1, a.c1, b.c1);
  fp2_add(o.c2, a.c2, b.c2);
}
static inline void fp6_sub(Fp6 &o, const Fp6 &a, const Fp6 &b) {
  fp2_sub(o.c0, a.c0, b.c0);
  fp2_sub(o.c1, a.c1, b.c1);
  fp2_sub(o.c2, a.c2, b.c2);
}
static inline void fp6_neg(Fp6 &o, const Fp6 &a) {
  fp2_neg(o.c0, a.c0);
  fp2_neg(o.c1, a.c1);
  fp2_neg(o.c2, a.c2);
}

static void fp6_mul(Fp6 &o, const Fp6 &a, const Fp6 &b) {
  Fp2 t0, t1, t2, s0, s1, m, r0, r1, r2;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  // c0 = ((a1+a2)(b1+b2) - t1 - t2)*nr + t0
  fp2_add(s0, a.c1, a.c2);
  fp2_add(s1, b.c1, b.c2);
  fp2_mul(m, s0, s1);
  fp2_sub(m, m, t1);
  fp2_sub(m, m, t2);
  fp2_mul_nr(r0, m);
  fp2_add(r0, r0, t0);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + t2*nr
  fp2_add(s0, a.c0, a.c1);
  fp2_add(s1, b.c0, b.c1);
  fp2_mul(m, s0, s1);
  fp2_sub(m, m, t0);
  fp2_sub(m, m, t1);
  fp2_mul_nr(r1, t2);
  fp2_add(r1, r1, m);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fp2_add(s0, a.c0, a.c2);
  fp2_add(s1, b.c0, b.c2);
  fp2_mul(m, s0, s1);
  fp2_sub(m, m, t0);
  fp2_sub(m, m, t2);
  fp2_add(r2, m, t1);
  o.c0 = r0;
  o.c1 = r1;
  o.c2 = r2;
}

static inline void fp6_sqr(Fp6 &o, const Fp6 &a) { fp6_mul(o, a, a); }

// multiply by v (the Fq12 non-residue)
static inline void fp6_mul_nr(Fp6 &o, const Fp6 &a) {
  Fp2 t;
  fp2_mul_nr(t, a.c2);
  Fp2 c0 = a.c0, c1 = a.c1;
  o.c0 = t;
  o.c1 = c0;
  o.c2 = c1;
}

static inline void fp6_mul_fp2(Fp6 &o, const Fp6 &a, const Fp2 &s) {
  fp2_mul(o.c0, a.c0, s);
  fp2_mul(o.c1, a.c1, s);
  fp2_mul(o.c2, a.c2, s);
}

static void fp6_inv(Fp6 &o, const Fp6 &a) {
  Fp2 t0, t1, t2, m, d, dinv;
  // t0 = a0^2 - (a1 a2) nr
  fp2_sqr(t0, a.c0);
  fp2_mul(m, a.c1, a.c2);
  fp2_mul_nr(m, m);
  fp2_sub(t0, t0, m);
  // t1 = a2^2 nr - a0 a1
  fp2_sqr(t1, a.c2);
  fp2_mul_nr(t1, t1);
  fp2_mul(m, a.c0, a.c1);
  fp2_sub(t1, t1, m);
  // t2 = a1^2 - a0 a2
  fp2_sqr(t2, a.c1);
  fp2_mul(m, a.c0, a.c2);
  fp2_sub(t2, t2, m);
  // denom = a0 t0 + (a2 t1 + a1 t2) nr
  Fp2 x, y;
  fp2_mul(x, a.c2, t1);
  fp2_mul(y, a.c1, t2);
  fp2_add(x, x, y);
  fp2_mul_nr(x, x);
  fp2_mul(d, a.c0, t0);
  fp2_add(d, d, x);
  fp2_inv(dinv, d);
  fp2_mul(o.c0, t0, dinv);
  fp2_mul(o.c1, t1, dinv);
  fp2_mul(o.c2, t2, dinv);
}

static void fp6_frob1(Fp6 &o, const Fp6 &a) {
  fp2_conj(o.c0, a.c0);
  Fp2 t;
  fp2_conj(t, a.c1);
  fp2_mul(o.c1, t, FROB6_C1[1]);
  fp2_conj(t, a.c2);
  fp2_mul(o.c2, t, FROB6_C2[1]);
}

static inline bool fp6_is_zero(const Fp6 &a) {
  return fp2_is_zero(a.c0) && fp2_is_zero(a.c1) && fp2_is_zero(a.c2);
}
static inline bool fp6_eq(const Fp6 &a, const Fp6 &b) {
  return fp2_eq(a.c0, b.c0) && fp2_eq(a.c1, b.c1) && fp2_eq(a.c2, b.c2);
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp12 {
  Fp6 c0, c1;
};

static Fp12 FP12_ONE;

static void fp12_mul(Fp12 &o, const Fp12 &a, const Fp12 &b) {
  Fp6 t0, t1, s0, s1, m;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(s0, a.c0, a.c1);
  fp6_add(s1, b.c0, b.c1);
  fp6_mul(m, s0, s1);
  Fp6 nr;
  fp6_mul_nr(nr, t1);
  fp6_add(o.c0, t0, nr);
  fp6_sub(m, m, t0);
  fp6_sub(o.c1, m, t1);
}

static void fp12_sqr(Fp12 &o, const Fp12 &a) {
  // c0 = (a0+a1)(a0 + a1 nr) - t0 - t0 nr ; c1 = 2 t0   with t0 = a0 a1
  Fp6 t0, s0, s1, m, nr;
  fp6_mul(t0, a.c0, a.c1);
  fp6_add(s0, a.c0, a.c1);
  fp6_mul_nr(nr, a.c1);
  fp6_add(s1, a.c0, nr);
  fp6_mul(m, s0, s1);
  fp6_sub(m, m, t0);
  fp6_mul_nr(nr, t0);
  fp6_sub(o.c0, m, nr);
  fp6_add(o.c1, t0, t0);
}

static inline void fp12_conj(Fp12 &o, const Fp12 &a) {
  o.c0 = a.c0;
  fp6_neg(o.c1, a.c1);
}

static void fp12_inv(Fp12 &o, const Fp12 &a) {
  Fp6 t0, t1, t;
  fp6_sqr(t0, a.c0);
  fp6_sqr(t1, a.c1);
  fp6_mul_nr(t1, t1);
  fp6_sub(t, t0, t1);
  fp6_inv(t, t);
  fp6_mul(o.c0, a.c0, t);
  fp6_mul(t, a.c1, t);
  fp6_neg(o.c1, t);
}

static void fp12_frob1(Fp12 &o, const Fp12 &a) {
  fp6_frob1(o.c0, a.c0);
  Fp6 t;
  fp6_frob1(t, a.c1);
  fp2_mul(o.c1.c0, t.c0, FROB12_C1[1]);
  fp2_mul(o.c1.c1, t.c1, FROB12_C1[1]);
  fp2_mul(o.c1.c2, t.c2, FROB12_C1[1]);
}

static void fp12_frob(Fp12 &o, const Fp12 &a, int power) {
  Fp12 r = a;
  for (int i = 0; i < power % 12; i++) fp12_frob1(r, r);
  o = r;
}

static inline bool fp12_is_one(const Fp12 &a) {
  return fp6_eq(a.c0, FP6_ONE) && fp6_is_zero(a.c1);
}

// Granger-Scott cyclotomic squaring (oracle fields.py:290-312).
static void fp12_cyclotomic_sqr(Fp12 &o, const Fp12 &a) {
  const Fp2 &z0 = a.c0.c0, &z4 = a.c0.c1, &z3 = a.c0.c2;
  const Fp2 &z2 = a.c1.c0, &z1 = a.c1.c1, &z5 = a.c1.c2;
  Fp2 t0, t1, t2, t3, t4, t5, s, q;

  // fq4_square(a, b): (b^2 nr + a^2, (a+b)^2 - a^2 - b^2)
#define FQ4_SQUARE(ra, rb, xa, xb)     \
  {                                    \
    Fp2 pa, pb, ps;                    \
    fp2_sqr(pa, xa);                   \
    fp2_sqr(pb, xb);                   \
    fp2_add(ps, xa, xb);               \
    fp2_sqr(ps, ps);                   \
    fp2_mul_nr(ra, pb);                \
    fp2_add(ra, ra, pa);               \
    fp2_sub(ps, ps, pa);               \
    fp2_sub(rb, ps, pb);               \
  }

  FQ4_SQUARE(t0, t1, z0, z1);
  FQ4_SQUARE(t2, t3, z2, z3);
  FQ4_SQUARE(t4, t5, z4, z5);
#undef FQ4_SQUARE

  Fp2 r0, r1, r2, r3, r4, r5;
  // z0' = (t0 - z0)*2 + t0
  fp2_sub(s, t0, z0);
  fp2_dbl(s, s);
  fp2_add(r0, s, t0);
  // z1' = (t1 + z1)*2 + t1
  fp2_add(s, t1, z1);
  fp2_dbl(s, s);
  fp2_add(r1, s, t1);
  // z2' = (t5 nr + z2)*2 + t5 nr
  fp2_mul_nr(q, t5);
  fp2_add(s, q, z2);
  fp2_dbl(s, s);
  fp2_add(r2, s, q);
  // z3' = (t4 - z3)*2 + t4
  fp2_sub(s, t4, z3);
  fp2_dbl(s, s);
  fp2_add(r3, s, t4);
  // z4' = (t2 - z4)*2 + t2
  fp2_sub(s, t2, z4);
  fp2_dbl(s, s);
  fp2_add(r4, s, t2);
  // z5' = (t3 + z5)*2 + t3
  fp2_add(s, t3, z5);
  fp2_dbl(s, s);
  fp2_add(r5, s, t3);

  o.c0.c0 = r0;
  o.c0.c1 = r4;
  o.c0.c2 = r3;
  o.c1.c0 = r2;
  o.c1.c1 = r1;
  o.c1.c2 = r5;
}

// f^|x| for cyclotomic f (MSB-first over the 64-bit |x|).
static void fp12_cyc_exp_abs_x(Fp12 &o, const Fp12 &f) {
  Fp12 r = f;  // MSB consumed
  for (int i = 62; i >= 0; i--) {
    fp12_cyclotomic_sqr(r, r);
    if ((BLS_X_ABS >> i) & 1) fp12_mul(r, r, f);
  }
  o = r;
}

// ---------------------------------------------------------------------------
// Elliptic curves: G1 over Fp (y^2 = x^3 + 4), G2 over Fp2 (y^2 = x^3 + 4(u+1))
// Jacobian coordinates; generic over the field via templates.
// ---------------------------------------------------------------------------

template <class F>
struct FieldOps;

template <>
struct FieldOps<Fp> {
  static void add(Fp &o, const Fp &a, const Fp &b) { fp_add(o, a, b); }
  static void sub(Fp &o, const Fp &a, const Fp &b) { fp_sub(o, a, b); }
  static void neg(Fp &o, const Fp &a) { fp_neg(o, a); }
  static void mul(Fp &o, const Fp &a, const Fp &b) { fp_mul(o, a, b); }
  static void sqr(Fp &o, const Fp &a) { fp_sqr(o, a); }
  static void inv(Fp &o, const Fp &a) { fp_inv(o, a); }
  static bool is_zero(const Fp &a) { return fp_is_zero(a); }
  static bool eq(const Fp &a, const Fp &b) { return fp_eq(a, b); }
  static const Fp &one() { return FP_ONE; }
  static const Fp &zero() { return FP_ZERO; }
};

static Fp2 FP2_ZERO_C, FP2_ONE_C;  // aliases stable for template refs

template <>
struct FieldOps<Fp2> {
  static void add(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_add(o, a, b); }
  static void sub(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_sub(o, a, b); }
  static void neg(Fp2 &o, const Fp2 &a) { fp2_neg(o, a); }
  static void mul(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_mul(o, a, b); }
  static void sqr(Fp2 &o, const Fp2 &a) { fp2_sqr(o, a); }
  static void inv(Fp2 &o, const Fp2 &a) { fp2_inv(o, a); }
  static bool is_zero(const Fp2 &a) { return fp2_is_zero(a); }
  static bool eq(const Fp2 &a, const Fp2 &b) { return fp2_eq(a, b); }
  static const Fp2 &one() { return FP2_ONE; }
  static const Fp2 &zero() { return FP2_ZERO; }
};

template <class F>
struct Jac {
  F X, Y, Z;  // Z == 0 -> infinity
};

template <class F>
struct Aff {
  F x, y;
  bool inf;
};

template <class F>
static void jac_set_inf(Jac<F> &p) {
  p.X = FieldOps<F>::one();
  p.Y = FieldOps<F>::one();
  p.Z = FieldOps<F>::zero();
}

template <class F>
static bool jac_is_inf(const Jac<F> &p) {
  return FieldOps<F>::is_zero(p.Z);
}

template <class F>
static void jac_from_aff(Jac<F> &o, const Aff<F> &a) {
  if (a.inf) {
    jac_set_inf(o);
    return;
  }
  o.X = a.x;
  o.Y = a.y;
  o.Z = FieldOps<F>::one();
}

template <class F>
static void jac_dbl(Jac<F> &o, const Jac<F> &p) {
  typedef FieldOps<F> O;
  if (jac_is_inf(p) || O::is_zero(p.Y)) {
    jac_set_inf(o);
    return;
  }
  F A, B, C, D, E, Fv, t, X3, Y3, Z3;
  O::sqr(A, p.X);
  O::sqr(B, p.Y);
  O::sqr(C, B);
  // D = 2((X+B)^2 - A - C)
  O::add(t, p.X, B);
  O::sqr(t, t);
  O::sub(t, t, A);
  O::sub(t, t, C);
  O::add(D, t, t);
  // E = 3A
  O::add(E, A, A);
  O::add(E, E, A);
  O::sqr(Fv, E);
  // X3 = F - 2D
  O::sub(X3, Fv, D);
  O::sub(X3, X3, D);
  // Y3 = E(D - X3) - 8C
  O::sub(t, D, X3);
  O::mul(Y3, E, t);
  O::add(t, C, C);
  O::add(t, t, t);
  O::add(t, t, t);
  O::sub(Y3, Y3, t);
  // Z3 = 2YZ
  O::mul(t, p.Y, p.Z);
  O::add(Z3, t, t);
  o.X = X3;
  o.Y = Y3;
  o.Z = Z3;
}

template <class F>
static void jac_add(Jac<F> &o, const Jac<F> &p, const Jac<F> &q) {
  typedef FieldOps<F> O;
  if (jac_is_inf(p)) {
    o = q;
    return;
  }
  if (jac_is_inf(q)) {
    o = p;
    return;
  }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  O::sqr(Z1Z1, p.Z);
  O::sqr(Z2Z2, q.Z);
  O::mul(U1, p.X, Z2Z2);
  O::mul(U2, q.X, Z1Z1);
  O::mul(t, q.Z, Z2Z2);
  O::mul(S1, p.Y, t);
  O::mul(t, p.Z, Z1Z1);
  O::mul(S2, q.Y, t);
  F H, R;
  O::sub(H, U2, U1);
  O::sub(R, S2, S1);
  if (O::is_zero(H)) {
    if (O::is_zero(R)) {
      jac_dbl(o, p);
      return;
    }
    jac_set_inf(o);
    return;
  }
  F HH, HHH, V, X3, Y3, Z3;
  O::sqr(HH, H);
  O::mul(HHH, HH, H);
  O::mul(V, U1, HH);
  // X3 = R^2 - HHH - 2V
  O::sqr(X3, R);
  O::sub(X3, X3, HHH);
  O::sub(X3, X3, V);
  O::sub(X3, X3, V);
  // Y3 = R(V - X3) - S1*HHH
  O::sub(t, V, X3);
  O::mul(Y3, R, t);
  O::mul(t, S1, HHH);
  O::sub(Y3, Y3, t);
  // Z3 = Z1 Z2 H
  O::mul(t, p.Z, q.Z);
  O::mul(Z3, t, H);
  o.X = X3;
  o.Y = Y3;
  o.Z = Z3;
}

template <class F>
static void jac_neg(Jac<F> &o, const Jac<F> &p) {
  o = p;
  FieldOps<F>::neg(o.Y, p.Y);
}

// MSB-first double-and-add: o = [e] p, exponent little-endian limbs.
template <class F>
static void jac_mul(Jac<F> &o, const Jac<F> &p, const u64 *e, int nbits) {
  Jac<F> r;
  jac_set_inf(r);
  for (int i = nbits - 1; i >= 0; i--) {
    jac_dbl(r, r);
    if ((e[i / 64] >> (i % 64)) & 1) jac_add(r, r, p);
  }
  o = r;
}

template <class F>
static void jac_to_aff(Aff<F> &o, const Jac<F> &p) {
  typedef FieldOps<F> O;
  if (jac_is_inf(p)) {
    o.inf = true;
    o.x = O::zero();
    o.y = O::zero();
    return;
  }
  F zi, zi2, zi3;
  O::inv(zi, p.Z);
  O::sqr(zi2, zi);
  O::mul(zi3, zi2, zi);
  O::mul(o.x, p.X, zi2);
  O::mul(o.y, p.Y, zi3);
  o.inf = false;
}

static Fp G1_B;   // 4 (Montgomery)
static Fp2 G2_B;  // 4(u+1)
static Aff<Fp> G1_GEN;
static Aff<Fp2> G2_GEN;

template <class F>
static bool on_curve(const Aff<F> &p, const F &b) {
  typedef FieldOps<F> O;
  if (p.inf) return true;
  F y2, x3;
  O::sqr(y2, p.y);
  O::sqr(x3, p.x);
  O::mul(x3, x3, p.x);
  O::add(x3, x3, b);
  return O::eq(y2, x3);
}

// psi endomorphism on E2 (untwist-frobenius-twist):
// psi(x, y) = (conj(x) * PSI_CX, conj(y) * PSI_CY), with
// PSI_CX = (u+1)^-((p-1)/3), PSI_CY = (u+1)^-((p-1)/2) (computed at init).
static Fp2 PSI_CX, PSI_CY;

static void g2_psi(Aff<Fp2> &o, const Aff<Fp2> &p) {
  if (p.inf) {
    o = p;
    return;
  }
  Fp2 t;
  fp2_conj(t, p.x);
  fp2_mul(o.x, t, PSI_CX);
  fp2_conj(t, p.y);
  fp2_mul(o.y, t, PSI_CY);
  o.inf = false;
}

// G2 subgroup check via the psi endomorphism: P in subgroup iff psi(P) == [x]P
// (x negative: [x]P = -[|x|]P). Same check as the device kernel g2.subgroup_check.
static bool g2_in_subgroup(const Aff<Fp2> &p) {
  if (p.inf) return true;
  if (!on_curve(p, G2_B)) return false;
  Jac<Fp2> j, xp;
  jac_from_aff(j, p);
  u64 xabs[1] = {BLS_X_ABS};
  jac_mul(xp, j, xabs, 64);
  jac_neg(xp, xp);  // [x]P with x < 0
  Aff<Fp2> lhs, rhs;
  jac_to_aff(rhs, xp);
  g2_psi(lhs, p);
  if (lhs.inf || rhs.inf) return lhs.inf && rhs.inf;
  return fp2_eq(lhs.x, rhs.x) && fp2_eq(lhs.y, rhs.y);
}

// G1 subgroup check: [r]P == inf (pubkeys are validated once per cache insert,
// mirroring validator_pubkey_cache.rs, so this is off the hot path).
static bool g1_in_subgroup(const Aff<Fp> &p) {
  if (p.inf) return true;
  if (!on_curve(p, G1_B)) return false;
  Jac<Fp> j, rp;
  jac_from_aff(j, p);
  jac_mul(rp, j, R_LIMBS, 255);
  return jac_is_inf(rp);
}

// ---------------------------------------------------------------------------
// Pairing: CLN homogeneous-projective Miller loop on the M-twist with sparse
// mul_by_014 folding (as lighthouse_tpu_torch/ops/bls/pairing.py).
// ---------------------------------------------------------------------------

// f *= c0 + c1 v + c4 v w  (Fq2 coefficients at Fq6-slot positions 0, 1, 4)
static void fp12_mul_by_014(Fp12 &f, const Fp2 &c0, const Fp2 &c1,
                            const Fp2 &c4) {
  // t0 = a0 * (c0, c1, 0)
  Fp6 t0, t1, t2;
  {
    const Fp6 &x = f.c0;
    Fp2 m00, m11, mx, m20, m21, s0, s1;
    fp2_mul(m00, x.c0, c0);
    fp2_mul(m11, x.c1, c1);
    fp2_add(s0, x.c0, x.c1);
    fp2_add(s1, c0, c1);
    fp2_mul(mx, s0, s1);
    fp2_mul(m20, x.c2, c0);
    fp2_mul(m21, x.c2, c1);
    fp2_mul_nr(t0.c0, m21);
    fp2_add(t0.c0, t0.c0, m00);
    fp2_sub(t0.c1, mx, m00);
    fp2_sub(t0.c1, t0.c1, m11);
    fp2_add(t0.c2, m11, m20);
  }
  // t1 = a1 * (0, c4, 0) = (nr(x2 c4), x0 c4, x1 c4)
  {
    const Fp6 &x = f.c1;
    Fp2 n0, n1, n2;
    fp2_mul(n0, x.c0, c4);
    fp2_mul(n1, x.c1, c4);
    fp2_mul(n2, x.c2, c4);
    fp2_mul_nr(t1.c0, n2);
    t1.c1 = n0;
    t1.c2 = n1;
  }
  // t2 = (a0 + a1) * (c0, c1 + c4, 0)
  {
    Fp6 s;
    fp6_add(s, f.c0, f.c1);
    Fp2 c14;
    fp2_add(c14, c1, c4);
    Fp2 m00, m11, mx, m20, m21, s0, s1;
    fp2_mul(m00, s.c0, c0);
    fp2_mul(m11, s.c1, c14);
    fp2_add(s0, s.c0, s.c1);
    fp2_add(s1, c0, c14);
    fp2_mul(mx, s0, s1);
    fp2_mul(m20, s.c2, c0);
    fp2_mul(m21, s.c2, c14);
    fp2_mul_nr(t2.c0, m21);
    fp2_add(t2.c0, t2.c0, m00);
    fp2_sub(t2.c1, mx, m00);
    fp2_sub(t2.c1, t2.c1, m11);
    fp2_add(t2.c2, m11, m20);
  }
  // out0 = t0 + nr(t1); out1 = t2 - t0 - t1
  Fp6 nr1;
  fp6_mul_nr(nr1, t1);
  fp6_add(f.c0, t0, nr1);
  fp6_sub(f.c1, t2, t0);
  fp6_sub(f.c1, f.c1, t1);
}

struct MillerState {
  Fp2 X, Y, Z;  // homogeneous projective on the twist
};

// Doubling step (ops/bls/pairing.py:_dbl_step): returns line (c0, c1, c2).
static void miller_dbl_step(MillerState &r, Fp2 &lc0, Fp2 &lc1, Fp2 &lc2) {
  Fp2 aj, b, c, j, s, h, e, f3, t, u;
  fp2_mul(aj, r.X, r.Y);
  fp2_sqr(b, r.Y);
  fp2_sqr(c, r.Z);
  fp2_sqr(j, r.X);
  fp2_add(s, r.Y, r.Z);
  fp2_sqr(s, s);
  // h = s - b - c
  fp2_sub(h, s, b);
  fp2_sub(h, h, c);
  // e = 12 nr(c)
  fp2_mul_nr(e, c);
  fp2_add(t, e, e);       // 2
  fp2_add(t, t, t);       // 4
  fp2_add(u, t, t);       // 8
  fp2_add(e, u, t);       // 12
  // f3 = 3e
  fp2_add(f3, e, e);
  fp2_add(f3, f3, e);
  // X3 = 2 a' (b - f3)
  Fp2 bmf, m0;
  fp2_sub(bmf, b, f3);
  fp2_mul(m0, aj, bmf);
  fp2_add(r.X, m0, m0);
  // Y3 = (b + f3)^2 - 12 e^2
  Fp2 bpf, m1, m2;
  fp2_add(bpf, b, f3);
  fp2_sqr(m1, bpf);
  fp2_sqr(m2, e);
  fp2_add(t, m2, m2);
  fp2_add(t, t, t);
  fp2_add(u, t, t);
  fp2_add(t, u, t);  // 12 m2
  fp2_sub(r.Y, m1, t);
  // Z3 = 4 b h
  Fp2 m3;
  fp2_mul(m3, b, h);
  fp2_add(m3, m3, m3);
  fp2_add(r.Z, m3, m3);
  // line = (e - b, 3j, -h)
  fp2_sub(lc0, e, b);
  fp2_add(lc1, j, j);
  fp2_add(lc1, lc1, j);
  fp2_neg(lc2, h);
}

// Mixed addition step (ops/bls/pairing.py:_add_step).
static void miller_add_step(MillerState &r, const Fp2 &qx, const Fp2 &qy,
                            Fp2 &lc0, Fp2 &lc1, Fp2 &lc2) {
  Fp2 theta, lam, c, d, e, f, g, h, t;
  fp2_mul(t, qy, r.Z);
  fp2_sub(theta, r.Y, t);
  fp2_mul(t, qx, r.Z);
  fp2_sub(lam, r.X, t);
  fp2_sqr(c, theta);
  fp2_sqr(d, lam);
  fp2_mul(e, lam, d);
  fp2_mul(f, r.Z, c);
  fp2_mul(g, r.X, d);
  // h = e + f - 2g
  fp2_add(h, e, f);
  fp2_sub(h, h, g);
  fp2_sub(h, h, g);
  // X3 = lam h; Y3 = theta (g - h) - e Y; Z3 = Z e
  Fp2 gmh, t1, t2;
  fp2_sub(gmh, g, h);
  fp2_mul(t1, theta, gmh);
  fp2_mul(t2, e, r.Y);
  fp2_mul(r.X, lam, h);
  fp2_sub(r.Y, t1, t2);
  fp2_mul(r.Z, r.Z, e);
  // line = (theta qx - lam qy, -theta, lam)
  fp2_mul(t1, theta, qx);
  fp2_mul(t2, lam, qy);
  fp2_sub(lc0, t1, t2);
  fp2_neg(lc1, theta);
  lc2 = lam;
}

// Fold a line into f: f *= (c0, c1 * px, c2 * py) at positions (0, 1, 4).
static inline void miller_ell(Fp12 &f, const Fp2 &lc0, const Fp2 &lc1,
                              const Fp2 &lc2, const Fp &px, const Fp &py) {
  Fp2 c1, c4;
  fp2_mul_fp(c1, lc1, px);
  fp2_mul_fp(c4, lc2, py);
  fp12_mul_by_014(f, lc0, c1, c4);
}

// Miller loop accumulating into f (callers pass f = 1 and chain for batches).
// P affine in G1 (Montgomery), Q affine on the twist. Infinity on either side
// contributes the identity (skipped), matching oracle miller_loop.
static void miller_loop_acc(Fp12 &f, const Aff<Fp> &p, const Aff<Fp2> &q) {
  if (p.inf || q.inf) return;
  MillerState r;
  r.X = q.x;
  r.Y = q.y;
  r.Z = FP2_ONE;
  Fp2 lc0, lc1, lc2;
  Fp12 acc = FP12_ONE;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(acc, acc);
    miller_dbl_step(r, lc0, lc1, lc2);
    miller_ell(acc, lc0, lc1, lc2, p.x, p.y);
    if ((BLS_X_ABS >> i) & 1) {
      miller_add_step(r, q.x, q.y, lc0, lc1, lc2);
      miller_ell(acc, lc0, lc1, lc2, p.x, p.y);
    }
  }
  Fp12 conj;
  fp12_conj(conj, acc);  // x < 0
  fp12_mul(f, f, conj);
}

// Final exponentiation: easy part then hard part f^(3(p^4-p^2+1)/r) via the
// x-addition chain 3λ = (x-1)^2 (x+p) (x^2+p^2-1) + 3 (oracle pairing.py:154).
static void final_exponentiation(Fp12 &o, const Fp12 &fin) {
  Fp12 f, t, inv;
  // easy: f^(p^6-1), then ^(p^2+1)
  fp12_conj(t, fin);
  fp12_inv(inv, fin);
  fp12_mul(f, t, inv);
  fp12_frob(t, f, 2);
  fp12_mul(f, t, f);

#define EXP_X_MINUS_1(out, g)     \
  {                               \
    Fp12 gx;                      \
    fp12_cyc_exp_abs_x(gx, g);    \
    fp12_mul(gx, gx, g);          \
    fp12_conj(out, gx);           \
  }

  Fp12 m1, m2, m2x, m3, m3x, m3x2, m4;
  EXP_X_MINUS_1(m1, f);
  EXP_X_MINUS_1(m2, m1);
#undef EXP_X_MINUS_1
  fp12_cyc_exp_abs_x(m2x, m2);
  fp12_conj(m2x, m2x);
  fp12_frob(t, m2, 1);
  fp12_mul(m3, m2x, t);
  fp12_cyc_exp_abs_x(m3x, m3);
  fp12_conj(m3x, m3x);
  fp12_cyc_exp_abs_x(m3x2, m3x);
  fp12_conj(m3x2, m3x2);
  fp12_frob(t, m3, 2);
  fp12_mul(m4, m3x2, t);
  fp12_conj(t, m3);
  fp12_mul(m4, m4, t);
  // * f^3
  fp12_mul(t, f, f);
  fp12_mul(t, t, f);
  fp12_mul(o, m4, t);
}

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4)
// ---------------------------------------------------------------------------

static const u32 SHA_K[64] = {
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

struct Sha256 {
  u32 h[8];
  u8 buf[64];
  u64 len;
  int fill;
};

static inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha_init(Sha256 &s) {
  static const u32 H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  memcpy(s.h, H0, sizeof(H0));
  s.len = 0;
  s.fill = 0;
}

static void sha_block(Sha256 &s, const u8 *p) {
  u32 w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((u32)p[4 * i] << 24) | ((u32)p[4 * i + 1] << 16) |
           ((u32)p[4 * i + 2] << 8) | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  u32 a = s.h[0], b = s.h[1], c = s.h[2], d = s.h[3];
  u32 e = s.h[4], f = s.h[5], g = s.h[6], hh = s.h[7];
  for (int i = 0; i < 64; i++) {
    u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = hh + S1 + ch + SHA_K[i] + w[i];
    u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    u32 mj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = S0 + mj;
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s.h[0] += a;
  s.h[1] += b;
  s.h[2] += c;
  s.h[3] += d;
  s.h[4] += e;
  s.h[5] += f;
  s.h[6] += g;
  s.h[7] += hh;
}

static void sha_update(Sha256 &s, const u8 *p, u64 n) {
  s.len += n;
  while (n) {
    if (s.fill == 0 && n >= 64) {
      sha_block(s, p);
      p += 64;
      n -= 64;
      continue;
    }
    u64 take = 64 - s.fill;
    if (take > n) take = n;
    memcpy(s.buf + s.fill, p, take);
    s.fill += (int)take;
    p += take;
    n -= take;
    if (s.fill == 64) {
      sha_block(s, s.buf);
      s.fill = 0;
    }
  }
}

static void sha_final(Sha256 &s, u8 out[32]) {
  u64 bits = s.len * 8;
  u8 pad = 0x80;
  sha_update(s, &pad, 1);
  u8 z = 0;
  while (s.fill != 56) sha_update(s, &z, 1);
  u8 lb[8];
  for (int i = 0; i < 8; i++) lb[i] = (u8)(bits >> (56 - 8 * i));
  sha_update(s, lb, 8);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (u8)(s.h[i] >> 24);
    out[4 * i + 1] = (u8)(s.h[i] >> 16);
    out[4 * i + 2] = (u8)(s.h[i] >> 8);
    out[4 * i + 3] = (u8)(s.h[i]);
  }
}

static void sha256(const u8 *p, u64 n, u8 out[32]) {
  Sha256 s;
  sha_init(s);
  sha_update(s, p, n);
  sha_final(s, out);
}

// ---------------------------------------------------------------------------
// Byte conversion + big-int helpers
// ---------------------------------------------------------------------------

static u64 HALF_P[6];  // (p-1)/2, raw

// raw o = 2*o mod p (o < p)
static void raw_shl1_mod_p(u64 o[6]) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += ((u128)o[i]) << 1;
    o[i] = (u64)c;
    c >>= 64;
  }
  if (c || fp_cmp_raw(o, P_LIMBS) >= 0) {
    u128 br = 0;
    for (int i = 0; i < 6; i++) {
      u128 d = (u128)o[i] - P_LIMBS[i] - (u64)br;
      o[i] = (u64)d;
      br = (d >> 64) ? 1 : 0;
    }
  }
}

// Interpret n big-endian bytes mod p -> Montgomery form.
static void fp_from_be_mod(Fp &o, const u8 *be, int n) {
  u64 r[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < n; i++) {
    for (int k = 0; k < 8; k++) raw_shl1_mod_p(r);
    // r += be[i] (no overflow: r < p, byte < 256, p has slack)
    u128 c = be[i];
    for (int j = 0; j < 6 && c; j++) {
      c += r[j];
      r[j] = (u64)c;
      c >>= 64;
    }
    if (fp_cmp_raw(r, P_LIMBS) >= 0) {
      u128 br = 0;
      for (int j = 0; j < 6; j++) {
        u128 d = (u128)r[j] - P_LIMBS[j] - (u64)br;
        r[j] = (u64)d;
        br = (d >> 64) ? 1 : 0;
      }
    }
  }
  Fp raw;
  memcpy(raw.l, r, 48);
  fp_to_mont(o, raw);
}

// Strict 48-byte big-endian parse (must be < p) -> Montgomery. False if >= p.
static bool fp_from_be48(Fp &o, const u8 *be) {
  u64 r[6];
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int k = 0; k < 8; k++) v = (v << 8) | be[8 * i + k];
    r[5 - i] = v;
  }
  if (fp_cmp_raw(r, P_LIMBS) >= 0) return false;
  Fp raw;
  memcpy(raw.l, r, 48);
  fp_to_mont(o, raw);
  return true;
}

static void fp_to_be48(const Fp &a, u8 *be) {
  Fp c;
  fp_from_mont(c, a);
  for (int i = 0; i < 6; i++) {
    u64 v = c.l[5 - i];
    for (int k = 0; k < 8; k++) be[8 * i + k] = (u8)(v >> (56 - 8 * k));
  }
}

// canonical(a) > (p-1)/2 ?
static bool fp_gt_half(const Fp &a) {
  Fp c;
  fp_from_mont(c, a);
  return fp_cmp_raw(c.l, HALF_P) > 0;
}

// Parse a big-endian hex string (no 0x) into Montgomery form.
static void fp_from_hex(Fp &o, const char *hex) {
  u8 be[48] = {0};
  int n = (int)strlen(hex);
  int nb = (n + 1) / 2;
  int off = 48 - nb;
  int i = 0;
  int hi = n & 1;  // odd length: first nibble is a lone hi nibble
  for (int b = 0; b < nb; b++) {
    u8 v = 0;
    for (int k = (b == 0 && hi) ? 1 : 0; k < 2; k++) {
      char ch = hex[i++];
      u8 d = (ch >= '0' && ch <= '9')   ? ch - '0'
             : (ch >= 'a' && ch <= 'f') ? ch - 'a' + 10
                                        : ch - 'A' + 10;
      v = (u8)((v << 4) | d);
    }
    be[off + b] = v;
  }
  bool ok = fp_from_be48(o, be);
  (void)ok;
}

// 256-bit big-endian bytes mod r (scalar order) -> 4 limbs little-endian.
static void scalar_from_be32_mod_r(u64 out[4], const u8 *be) {
  u64 t[4] = {0, 0, 0, 0};
  for (int i = 0; i < 32; i++) {
    for (int k = 0; k < 8; k++) {
      // t = 2t mod r
      u128 c = 0;
      for (int j = 0; j < 4; j++) {
        c += ((u128)t[j]) << 1;
        t[j] = (u64)c;
        c >>= 64;
      }
      bool ge = (bool)c;
      if (!ge) {
        ge = true;
        for (int j = 3; j >= 0; j--) {
          if (t[j] < R_LIMBS[j]) {
            ge = false;
            break;
          }
          if (t[j] > R_LIMBS[j]) break;
        }
      }
      if (ge) {
        u128 br = 0;
        for (int j = 0; j < 4; j++) {
          u128 d = (u128)t[j] - R_LIMBS[j] - (u64)br;
          t[j] = (u64)d;
          br = (d >> 64) ? 1 : 0;
        }
      }
    }
    u128 c = be[i];
    for (int j = 0; j < 4 && c; j++) {
      c += t[j];
      t[j] = (u64)c;
      c >>= 64;
    }
  }
  memcpy(out, t, 32);
}

// ---------------------------------------------------------------------------
// Point serialization (ZCash flags; oracle curves.py:241-318)
// ---------------------------------------------------------------------------

static bool g1_decompress(Aff<Fp> &o, const u8 *in) {
  int c_flag = (in[0] >> 7) & 1, i_flag = (in[0] >> 6) & 1,
      s_flag = (in[0] >> 5) & 1;
  if (!c_flag) return false;
  u8 be[48];
  memcpy(be, in, 48);
  be[0] &= 0x1f;
  if (i_flag) {
    for (int i = 0; i < 48; i++)
      if (be[i]) return false;
    if (s_flag) return false;
    o.inf = true;
    o.x = FP_ZERO;
    o.y = FP_ZERO;
    return true;
  }
  if (!fp_from_be48(o.x, be)) return false;
  Fp rhs;
  fp_sqr(rhs, o.x);
  fp_mul(rhs, rhs, o.x);
  fp_add(rhs, rhs, G1_B);
  if (!fp_sqrt(o.y, rhs)) return false;
  if (fp_gt_half(o.y) != (bool)s_flag) fp_neg(o.y, o.y);
  o.inf = false;
  return true;
}

static void g1_compress(const Aff<Fp> &p, u8 *out) {
  if (p.inf) {
    memset(out, 0, 48);
    out[0] = 0xc0;
    return;
  }
  fp_to_be48(p.x, out);
  out[0] |= 0x80 | (fp_gt_half(p.y) ? 0x20 : 0);
}

static bool fp2_gt_half_lex(const Fp2 &y) {
  if (!fp_is_zero(y.c1)) return fp_gt_half(y.c1);
  return fp_gt_half(y.c0);
}

static bool g2_decompress(Aff<Fp2> &o, const u8 *in) {
  int c_flag = (in[0] >> 7) & 1, i_flag = (in[0] >> 6) & 1,
      s_flag = (in[0] >> 5) & 1;
  if (!c_flag) return false;
  u8 be[96];
  memcpy(be, in, 96);
  be[0] &= 0x1f;
  if (i_flag) {
    for (int i = 0; i < 96; i++)
      if (be[i]) return false;
    if (s_flag) return false;
    o.inf = true;
    o.x = FP2_ZERO;
    o.y = FP2_ZERO;
    return true;
  }
  // layout: x.c1 first, then x.c0
  if (!fp_from_be48(o.x.c1, be)) return false;
  if (!fp_from_be48(o.x.c0, be + 48)) return false;
  Fp2 rhs;
  fp2_sqr(rhs, o.x);
  fp2_mul(rhs, rhs, o.x);
  fp2_add(rhs, rhs, G2_B);
  if (!fp2_sqrt(o.y, rhs)) return false;
  if (fp2_gt_half_lex(o.y) != (bool)s_flag) fp2_neg(o.y, o.y);
  o.inf = false;
  return true;
}

static void g2_compress(const Aff<Fp2> &p, u8 *out) {
  if (p.inf) {
    memset(out, 0, 96);
    out[0] = 0xc0;
    return;
  }
  fp_to_be48(p.x.c1, out);
  fp_to_be48(p.x.c0, out + 48);
  out[0] |= 0x80 | (fp2_gt_half_lex(p.y) ? 0x20 : 0);
}

// ---------------------------------------------------------------------------
// Hash-to-curve G2: BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380; as
// lighthouse_tpu_torch/oracle/hash_to_curve.py)
// ---------------------------------------------------------------------------

static const char DST[] = "BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_";
#define DST_LEN 43

// expand_message_xmd for len_in_bytes = 256 (count=2, m=2, L=64)
static void expand_message_xmd_256(const u8 *msg, u64 msg_len, u8 out[256]) {
  u8 b0[32], bi[32];
  u8 dst_prime[DST_LEN + 1];
  memcpy(dst_prime, DST, DST_LEN);
  dst_prime[DST_LEN] = DST_LEN;
  // b0 = H(z_pad || msg || l_i_b_str || 0x00 || dst_prime)
  Sha256 s;
  sha_init(s);
  u8 zpad[64] = {0};
  sha_update(s, zpad, 64);
  sha_update(s, msg, msg_len);
  u8 lib[3] = {(u8)(256 >> 8), (u8)(256 & 0xff), 0x00};
  sha_update(s, lib, 3);
  sha_update(s, dst_prime, DST_LEN + 1);
  sha_final(s, b0);
  // b1 = H(b0 || 0x01 || dst_prime)
  sha_init(s);
  sha_update(s, b0, 32);
  u8 one = 1;
  sha_update(s, &one, 1);
  sha_update(s, dst_prime, DST_LEN + 1);
  sha_final(s, bi);
  memcpy(out, bi, 32);
  for (int i = 2; i <= 8; i++) {
    u8 tmp[32];
    for (int k = 0; k < 32; k++) tmp[k] = b0[k] ^ bi[k];
    sha_init(s);
    sha_update(s, tmp, 32);
    u8 ib = (u8)i;
    sha_update(s, &ib, 1);
    sha_update(s, dst_prime, DST_LEN + 1);
    sha_final(s, bi);
    memcpy(out + 32 * (i - 1), bi, 32);
  }
}

// SSWU + 3-isogeny constants (RFC 9380 8.8.2 and appendix E.3; values as in
// the oracle). Filled at init.
static Fp2 ISO_A, ISO_B, SSWU_Z;
static Fp2 ISO_XNUM[4], ISO_XDEN[3], ISO_YNUM[4], ISO_YDEN[4];
static Fp2 SSWU_MBA;  // -B/A precomputed
static Fp2 SSWU_BZA;  // B/(Z*A)

static void fp2_inv0(Fp2 &o, const Fp2 &a) {
  if (fp2_is_zero(a)) {
    o = FP2_ZERO;
    return;
  }
  fp2_inv(o, a);
}

// Simplified SWU mapping to the iso-curve E' (oracle map_to_curve_sswu).
static void map_to_curve_sswu(Aff<Fp2> &o, const Fp2 &u) {
  Fp2 u2, zu2, t, tv1, x1, gx1, x2, gx2, y;
  fp2_sqr(u2, u);
  fp2_mul(zu2, SSWU_Z, u2);
  // tv1 = inv0(Z^2 u^4 + Z u^2) = inv0(zu2^2 + zu2)
  fp2_sqr(t, zu2);
  fp2_add(t, t, zu2);
  fp2_inv0(tv1, t);
  if (fp2_is_zero(tv1)) {
    x1 = SSWU_BZA;
  } else {
    fp2_add(t, FP2_ONE, tv1);
    fp2_mul(x1, SSWU_MBA, t);
  }
  // gx1 = (x1^2 + A) x1 + B
  fp2_sqr(t, x1);
  fp2_add(t, t, ISO_A);
  fp2_mul(gx1, t, x1);
  fp2_add(gx1, gx1, ISO_B);
  fp2_mul(x2, zu2, x1);
  fp2_sqr(t, x2);
  fp2_add(t, t, ISO_A);
  fp2_mul(gx2, t, x2);
  fp2_add(gx2, gx2, ISO_B);
  Fp2 x;
  if (fp2_sqrt(y, gx1)) {
    x = x1;
  } else {
    bool ok = fp2_sqrt(y, gx2);
    (void)ok;  // RFC guarantee: gx2 is square when gx1 is not
    x = x2;
  }
  if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
  o.x = x;
  o.y = y;
  o.inf = false;
}

static void iso_horner(Fp2 &o, const Fp2 *k, int n, const Fp2 &x) {
  Fp2 acc = k[n - 1];
  for (int i = n - 2; i >= 0; i--) {
    fp2_mul(acc, acc, x);
    fp2_add(acc, acc, k[i]);
  }
  o = acc;
}

static void iso_map(Aff<Fp2> &o, const Aff<Fp2> &p) {
  // alias-safe for &o == &p: finish all reads of p before writing o
  Fp2 xn, xd, yn, yd, t;
  iso_horner(xn, ISO_XNUM, 4, p.x);
  iso_horner(xd, ISO_XDEN, 3, p.x);
  iso_horner(yn, ISO_YNUM, 4, p.x);
  iso_horner(yd, ISO_YDEN, 4, p.x);
  fp2_inv(t, yd);
  fp2_mul(t, yn, t);
  fp2_mul(o.y, p.y, t);
  fp2_inv(t, xd);
  fp2_mul(o.x, xn, t);
  o.inf = false;
}

// Budroni-Pintore cofactor clearing: [x^2-x-1]P + [x-1]psi(P) + psi^2(2P).
// x negative: x^2-x-1 = |x|^2+|x|-1 >= 0; [x-1]Q = -[|x|+1]Q.
static void clear_cofactor_psi(Jac<Fp2> &o, const Aff<Fp2> &p) {
  u64 e1[3];
  u128 sq = (u128)BLS_X_ABS * BLS_X_ABS;
  u128 lo = (u128)(u64)sq + BLS_X_ABS - 1;
  e1[0] = (u64)lo;
  u128 hi = (u128)(u64)(sq >> 64) + (u64)(lo >> 64);
  e1[1] = (u64)hi;
  e1[2] = (u64)(hi >> 64);
  u64 e2[2];
  u128 xp1 = (u128)BLS_X_ABS + 1;
  e2[0] = (u64)xp1;
  e2[1] = (u64)(xp1 >> 64);

  Jac<Fp2> jp, t1, t2, t3;
  jac_from_aff(jp, p);
  jac_mul(t1, jp, e1, 129);  // [|x|^2+|x|-1]P
  Aff<Fp2> psip, psi2p2;
  g2_psi(psip, p);
  Jac<Fp2> jpsi;
  jac_from_aff(jpsi, psip);
  jac_mul(t2, jpsi, e2, 65);  // [|x|+1]psi(P)
  jac_neg(t2, t2);            // [x-1]psi(P)
  // psi^2(2P)
  Jac<Fp2> j2p;
  jac_dbl(j2p, jp);
  Aff<Fp2> a2p;
  jac_to_aff(a2p, j2p);
  g2_psi(psi2p2, a2p);
  g2_psi(psi2p2, psi2p2);
  jac_from_aff(t3, psi2p2);
  jac_add(o, t1, t2);
  jac_add(o, o, t3);
}

// Full hash_to_curve_g2 (affine out).
static void hash_to_g2(Aff<Fp2> &o, const u8 *msg, u64 msg_len) {
  u8 uni[256];
  expand_message_xmd_256(msg, msg_len, uni);
  Fp2 u0, u1;
  fp_from_be_mod(u0.c0, uni, 64);
  fp_from_be_mod(u0.c1, uni + 64, 64);
  fp_from_be_mod(u1.c0, uni + 128, 64);
  fp_from_be_mod(u1.c1, uni + 192, 64);
  Aff<Fp2> q0, q1;
  map_to_curve_sswu(q0, u0);
  iso_map(q0, q0);
  map_to_curve_sswu(q1, u1);
  iso_map(q1, q1);
  Jac<Fp2> j0, j1, sum, cleared;
  jac_from_aff(j0, q0);
  jac_from_aff(j1, q1);
  jac_add(sum, j0, j1);
  Aff<Fp2> asum;
  jac_to_aff(asum, sum);
  clear_cofactor_psi(cleared, asum);
  jac_to_aff(o, cleared);
}

// ---------------------------------------------------------------------------
// Init
// ---------------------------------------------------------------------------

static Aff<Fp> NEG_G1_GEN;
static bool INITIALIZED = false;

// long-divide the raw 6-limb value a by small d (exact or floor)
static void raw_div_small(u64 o[6], const u64 a[6], u64 d) {
  u128 rem = 0;
  for (int i = 5; i >= 0; i--) {
    u128 cur = (rem << 64) | a[i];
    o[i] = (u64)(cur / d);
    rem = cur % d;
  }
}

extern "C" int bls_native_init() {
  if (INITIALIZED) return 0;
  // MONT_INV = -p^{-1} mod 2^64 (Newton)
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - P_LIMBS[0] * inv;
  MONT_INV = (u64)(0 - inv);
  // FP_ONE = 2^384 mod p; R2 = 2^768 mod p
  u64 t[6] = {1, 0, 0, 0, 0, 0};
  for (int i = 0; i < 384; i++) raw_shl1_mod_p(t);
  memcpy(FP_ONE.l, t, 48);
  for (int i = 0; i < 384; i++) raw_shl1_mod_p(t);
  memcpy(R2.l, t, 48);
  // HALF_P = (p-1)/2
  u64 pm1[6];
  memcpy(pm1, P_LIMBS, 48);
  pm1[0] -= 1;  // p is odd
  raw_div_small(HALF_P, pm1, 2);
  // exponents
  memcpy(EXP_P_MINUS_2, P_LIMBS, 48);
  EXP_P_MINUS_2[0] -= 2;
  u64 pp1[6];
  memcpy(pp1, P_LIMBS, 48);
  pp1[0] += 1;  // no carry: p ends 0xaaab
  raw_div_small(EXP_P_PLUS_1_D4, pp1, 4);
  u64 pm3[6];
  memcpy(pm3, P_LIMBS, 48);
  pm3[0] -= 3;
  raw_div_small(EXP_P_MINUS_3_D4, pm3, 4);
  raw_div_small(EXP_P_MINUS_1_D2, pm1, 2);
  raw_div_small(EXP_P_MINUS_1_D3, pm1, 3);
  raw_div_small(EXP_P_MINUS_1_D6, pm1, 6);

  // tower constants
  FP2_ZERO.c0 = FP_ZERO;
  FP2_ZERO.c1 = FP_ZERO;
  FP2_ONE.c0 = FP_ONE;
  FP2_ONE.c1 = FP_ZERO;
  FP6_ZERO.c0 = FP2_ZERO;
  FP6_ZERO.c1 = FP2_ZERO;
  FP6_ZERO.c2 = FP2_ZERO;
  FP6_ONE.c0 = FP2_ONE;
  FP6_ONE.c1 = FP2_ZERO;
  FP6_ONE.c2 = FP2_ZERO;
  FP12_ONE.c0 = FP6_ONE;
  FP12_ONE.c1 = FP6_ZERO;

  // frobenius coefficients: xi = u+1
  Fp2 xi;
  xi.c0 = FP_ONE;
  xi.c1 = FP_ONE;
  fp2_pow(FROB6_C1[1], xi, EXP_P_MINUS_1_D3, 381);
  Fp2 xi2;
  fp2_sqr(xi2, xi);
  fp2_pow(FROB6_C2[1], xi2, EXP_P_MINUS_1_D3, 381);  // xi^(2(p-1)/3)
  fp2_pow(FROB12_C1[1], xi, EXP_P_MINUS_1_D6, 381);

  // psi coefficients: inverses of xi^((p-1)/3), xi^((p-1)/2)
  fp2_inv(PSI_CX, FROB6_C1[1]);
  Fp2 xi_half;
  fp2_pow(xi_half, xi, EXP_P_MINUS_1_D2, 381);
  fp2_inv(PSI_CY, xi_half);

  // curve constants
  Fp four_raw = {{4, 0, 0, 0, 0, 0}};
  fp_to_mont(G1_B, four_raw);
  G2_B.c0 = G1_B;
  G2_B.c1 = G1_B;

  // generators (canonical limbs, little-endian; spec constants)
  static const u64 G1X[6] = {0xfb3af00adb22c6bbULL, 0x6c55e83ff97a1aefULL,
                             0xa14e3a3f171bac58ULL, 0xc3688c4f9774b905ULL,
                             0x2695638c4fa9ac0fULL, 0x17f1d3a73197d794ULL};
  static const u64 G1Y[6] = {0x0caa232946c5e7e1ULL, 0xd03cc744a2888ae4ULL,
                             0x00db18cb2c04b3edULL, 0xfcf5e095d5d00af6ULL,
                             0xa09e30ed741d8ae4ULL, 0x08b3f481e3aaa0f1ULL};
  static const u64 G2X0[6] = {0xd48056c8c121bdb8ULL, 0x0bac0326a805bbefULL,
                              0xb4510b647ae3d177ULL, 0xc6e47ad4fa403b02ULL,
                              0x260805272dc51051ULL, 0x024aa2b2f08f0a91ULL};
  static const u64 G2X1[6] = {0xe5ac7d055d042b7eULL, 0x334cf11213945d57ULL,
                              0xb5da61bbdc7f5049ULL, 0x596bd0d09920b61aULL,
                              0x7dacd3a088274f65ULL, 0x13e02b6052719f60ULL};
  static const u64 G2Y0[6] = {0xe193548608b82801ULL, 0x923ac9cc3baca289ULL,
                              0x6d429a695160d12cULL, 0xadfd9baa8cbdd3a7ULL,
                              0x8cc9cdc6da2e351aULL, 0x0ce5d527727d6e11ULL};
  static const u64 G2Y1[6] = {0xaaa9075ff05f79beULL, 0x3f370d275cec1da1ULL,
                              0x267492ab572e99abULL, 0xcb3e287e85a763afULL,
                              0x32acd2b02bc28b99ULL, 0x0606c4a02ea734ccULL};
  Fp raw;
  memcpy(raw.l, G1X, 48);
  fp_to_mont(G1_GEN.x, raw);
  memcpy(raw.l, G1Y, 48);
  fp_to_mont(G1_GEN.y, raw);
  G1_GEN.inf = false;
  memcpy(raw.l, G2X0, 48);
  fp_to_mont(G2_GEN.x.c0, raw);
  memcpy(raw.l, G2X1, 48);
  fp_to_mont(G2_GEN.x.c1, raw);
  memcpy(raw.l, G2Y0, 48);
  fp_to_mont(G2_GEN.y.c0, raw);
  memcpy(raw.l, G2Y1, 48);
  fp_to_mont(G2_GEN.y.c1, raw);
  G2_GEN.inf = false;
  if (!on_curve(G1_GEN, G1_B) || !on_curve(G2_GEN, G2_B)) return -1;
  NEG_G1_GEN = G1_GEN;
  fp_neg(NEG_G1_GEN.y, G1_GEN.y);

  // SSWU constants: A' = 240u, B' = 1012(1+u), Z = -(2+u)
  Fp v240, v1012;
  Fp raw240 = {{240, 0, 0, 0, 0, 0}}, raw1012 = {{1012, 0, 0, 0, 0, 0}};
  fp_to_mont(v240, raw240);
  fp_to_mont(v1012, raw1012);
  ISO_A.c0 = FP_ZERO;
  ISO_A.c1 = v240;
  ISO_B.c0 = v1012;
  ISO_B.c1 = v1012;
  Fp two_raw = {{2, 0, 0, 0, 0, 0}}, m2, m1;
  fp_to_mont(m2, two_raw);
  fp_neg(SSWU_Z.c0, m2);
  fp_neg(SSWU_Z.c1, FP_ONE);
  (void)m1;
  // -B/A and B/(Z*A)
  Fp2 ainv, t2;
  fp2_inv(ainv, ISO_A);
  fp2_mul(SSWU_MBA, ISO_B, ainv);
  fp2_neg(SSWU_MBA, SSWU_MBA);
  fp2_mul(t2, SSWU_Z, ISO_A);
  fp2_inv(t2, t2);
  fp2_mul(SSWU_BZA, ISO_B, t2);

  // 3-isogeny constants (RFC 9380 E.3, as in oracle hash_to_curve.py)
#define K2(dst, h0, h1)        \
  fp_from_hex(dst.c0, h0);     \
  fp_from_hex(dst.c1, h1);
  K2(ISO_XNUM[0],
     "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6",
     "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6");
  K2(ISO_XNUM[1], "0",
     "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71a");
  K2(ISO_XNUM[2],
     "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71e",
     "8ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38d");
  K2(ISO_XNUM[3],
     "171d6541fa38ccfaed6dea691f5fb614cb14b4e7f4e810aa22d6108f142b85757098e38d0f671c7188e2aaaaaaaa5ed1",
     "0");
  K2(ISO_XDEN[0], "0",
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa63");
  K2(ISO_XDEN[1], "c",
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa9f");
  ISO_XDEN[2] = FP2_ONE;
  K2(ISO_YNUM[0],
     "1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706",
     "1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706");
  K2(ISO_YNUM[1], "0",
     "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97be");
  K2(ISO_YNUM[2],
     "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71c",
     "8ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38f");
  K2(ISO_YNUM[3],
     "124c9ad43b6cf79bfbf7043de3811ad0761b0f37a1e26286b0e977c69aa274524e79097a56dc4bd9e1b371c71c718b10",
     "0");
  K2(ISO_YDEN[0],
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa8fb",
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa8fb");
  K2(ISO_YDEN[1], "0",
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa9d3");
  K2(ISO_YDEN[2], "12",
     "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa99");
  ISO_YDEN[3] = FP2_ONE;
#undef K2

  INITIALIZED = true;
  return 0;
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

extern "C" void bls_sk_to_pk(const u8 sk[32], u8 out[48]) {
  u64 e[4];
  scalar_from_be32_mod_r(e, sk);
  Jac<Fp> g, r;
  jac_from_aff(g, G1_GEN);
  jac_mul(r, g, e, 255);
  Aff<Fp> a;
  jac_to_aff(a, r);
  g1_compress(a, out);
}

extern "C" void bls_sign(const u8 sk[32], const u8 *msg, u64 msg_len,
                         u8 out[96]) {
  u64 e[4];
  scalar_from_be32_mod_r(e, sk);
  Aff<Fp2> h;
  hash_to_g2(h, msg, msg_len);
  Jac<Fp2> j, r;
  jac_from_aff(j, h);
  jac_mul(r, j, e, 255);
  Aff<Fp2> a;
  jac_to_aff(a, r);
  g2_compress(a, out);
}

extern "C" void bls_hash_to_g2(const u8 *msg, u64 msg_len, u8 out[96]) {
  Aff<Fp2> h;
  hash_to_g2(h, msg, msg_len);
  g2_compress(h, out);
}

// key_validate (blst.rs:75 semantics): decompress + not-infinity + subgroup.
extern "C" int bls_pk_validate(const u8 pk[48]) {
  Aff<Fp> p;
  if (!g1_decompress(p, pk)) return 0;
  if (p.inf) return 0;
  return g1_in_subgroup(p) ? 1 : 0;
}

extern "C" int bls_sig_validate(const u8 sig[96]) {
  Aff<Fp2> s;
  if (!g2_decompress(s, sig)) return 0;
  if (s.inf) return 0;
  return g2_in_subgroup(s) ? 1 : 0;
}

static bool decompress_pks_sum(Jac<Fp> &acc, u64 n, const u8 *pks) {
  jac_set_inf(acc);
  for (u64 i = 0; i < n; i++) {
    Aff<Fp> p;
    if (!g1_decompress(p, pks + 48 * i)) return false;
    Jac<Fp> j;
    jac_from_aff(j, p);
    jac_add(acc, acc, j);
  }
  return true;
}

// core verification: e(pk, H(m)) * e(-g1, sig) == 1
static int verify_inner(const Aff<Fp> &pk, const u8 *msg, u64 msg_len,
                        const Aff<Fp2> &sig) {
  if (pk.inf || sig.inf) return 0;
  if (!g2_in_subgroup(sig)) return 0;
  Aff<Fp2> h;
  hash_to_g2(h, msg, msg_len);
  Fp12 f = FP12_ONE;
  miller_loop_acc(f, pk, h);
  miller_loop_acc(f, NEG_G1_GEN, sig);
  Fp12 r;
  final_exponentiation(r, f);
  return fp12_is_one(r) ? 1 : 0;
}

extern "C" int bls_verify(const u8 pk[48], const u8 *msg, u64 msg_len,
                          const u8 sig[96]) {
  Aff<Fp> p;
  Aff<Fp2> s;
  if (!g1_decompress(p, pk) || p.inf || !g1_in_subgroup(p)) return 0;
  if (!g2_decompress(s, sig)) return 0;
  return verify_inner(p, msg, msg_len, s);
}

// All signers signed the same message; pubkeys must be pre-validated
// (fast_aggregate_verify per the Eth2 spec; blst.rs aggregate path).
extern "C" int bls_fast_aggregate_verify(u64 n, const u8 *pks, const u8 *msg,
                                         u64 msg_len, const u8 sig[96]) {
  if (n == 0) return 0;
  Jac<Fp> acc;
  if (!decompress_pks_sum(acc, n, pks)) return 0;
  Aff<Fp> apk;
  jac_to_aff(apk, acc);
  Aff<Fp2> s;
  if (!g2_decompress(s, sig)) return 0;
  return verify_inner(apk, msg, msg_len, s);
}

extern "C" int bls_aggregate_pubkeys(u64 n, const u8 *pks, u8 out[48]) {
  Jac<Fp> acc;
  if (!decompress_pks_sum(acc, n, pks)) return -1;
  Aff<Fp> a;
  jac_to_aff(a, acc);
  g1_compress(a, out);
  return 0;
}

extern "C" int bls_aggregate_signatures(u64 n, const u8 *sigs, u8 out[96]) {
  Jac<Fp2> acc;
  jac_set_inf(acc);
  for (u64 i = 0; i < n; i++) {
    Aff<Fp2> s;
    if (!g2_decompress(s, sigs + 96 * i)) return -1;
    Jac<Fp2> j;
    jac_from_aff(j, s);
    jac_add(acc, acc, j);
  }
  Aff<Fp2> a;
  jac_to_aff(a, acc);
  g2_compress(a, out);
  return 0;
}

// Random-linear-combination batch verification over signature sets — the
// native twin of blst's verify_multiple_aggregate_signatures (blst.rs:37-119)
// and of the device arm (bls/backend.py):
//   prod_i e(r_i * agg_pk_i, H(m_i)) * e(-g1, sum_i r_i * sig_i) == 1
// pk_counts[i] pubkeys per set (48B compressed each, concatenated in pks);
// msgs = n_sets * 32B message roots; sigs = n_sets * 96B; scalars nonzero u64.
// Returns 1 verified, 0 rejected, -1 malformed input.
extern "C" int bls_verify_signature_sets(u64 n_sets, const u64 *pk_counts,
                                         const u8 *pks, const u8 *msgs,
                                         const u8 *sigs, const u64 *scalars) {
  if (n_sets == 0) return 0;
  Fp12 f = FP12_ONE;
  Jac<Fp2> sig_acc;
  jac_set_inf(sig_acc);
  u64 pk_off = 0;
  for (u64 i = 0; i < n_sets; i++) {
    // aggregate this set's pubkeys
    Jac<Fp> agg;
    if (!decompress_pks_sum(agg, pk_counts[i], pks + 48 * pk_off)) return -1;
    pk_off += pk_counts[i];
    Aff<Fp> apk;
    jac_to_aff(apk, agg);
    if (apk.inf) return 0;
    // signature: subgroup check, then scale and accumulate
    Aff<Fp2> sig;
    if (!g2_decompress(sig, sigs + 96 * i)) return -1;
    if (sig.inf || !g2_in_subgroup(sig)) return 0;
    u64 r = scalars[i] ? scalars[i] : 1;
    Jac<Fp2> js, rs;
    jac_from_aff(js, sig);
    jac_mul(rs, js, &r, 64);
    jac_add(sig_acc, sig_acc, rs);
    // scaled pubkey against H(m)
    Jac<Fp> jp, rp;
    jac_from_aff(jp, apk);
    jac_mul(rp, jp, &r, 64);
    Aff<Fp> spk;
    jac_to_aff(spk, rp);
    Aff<Fp2> h;
    hash_to_g2(h, msgs + 32 * i, 32);
    miller_loop_acc(f, spk, h);
  }
  Aff<Fp2> sacc;
  jac_to_aff(sacc, sig_acc);
  miller_loop_acc(f, NEG_G1_GEN, sacc);
  Fp12 r;
  final_exponentiation(r, f);
  return fp12_is_one(r) ? 1 : 0;
}

// Debug exports (parity bisection in tests; raw 48-byte BE field elements).
extern "C" void bls_dbg_expand256(const u8 *msg, u64 len, u8 out[256]) {
  expand_message_xmd_256(msg, len, out);
}

extern "C" void bls_dbg_h2f(const u8 *msg, u64 len, u8 out[192]) {
  u8 uni[256];
  expand_message_xmd_256(msg, len, uni);
  Fp2 u0, u1;
  fp_from_be_mod(u0.c0, uni, 64);
  fp_from_be_mod(u0.c1, uni + 64, 64);
  fp_from_be_mod(u1.c0, uni + 128, 64);
  fp_from_be_mod(u1.c1, uni + 192, 64);
  fp_to_be48(u0.c0, out);
  fp_to_be48(u0.c1, out + 48);
  fp_to_be48(u1.c0, out + 96);
  fp_to_be48(u1.c1, out + 144);
}

extern "C" int bls_dbg_sswu(const u8 in[96], u8 out[192]) {
  Fp2 u;
  if (!fp_from_be48(u.c0, in) || !fp_from_be48(u.c1, in + 48)) return -1;
  Aff<Fp2> q;
  map_to_curve_sswu(q, u);
  fp_to_be48(q.x.c0, out);
  fp_to_be48(q.x.c1, out + 48);
  fp_to_be48(q.y.c0, out + 96);
  fp_to_be48(q.y.c1, out + 144);
  return 0;
}

extern "C" int bls_dbg_sswu_iso(const u8 in[96], u8 out[192]) {
  Fp2 u;
  if (!fp_from_be48(u.c0, in) || !fp_from_be48(u.c1, in + 48)) return -1;
  Aff<Fp2> q;
  map_to_curve_sswu(q, u);
  iso_map(q, q);
  fp_to_be48(q.x.c0, out);
  fp_to_be48(q.x.c1, out + 48);
  fp_to_be48(q.y.c0, out + 96);
  fp_to_be48(q.y.c1, out + 144);
  return 0;
}

extern "C" int bls_dbg_clear(const u8 in[192], u8 out[96]) {
  Aff<Fp2> p;
  if (!fp_from_be48(p.x.c0, in) || !fp_from_be48(p.x.c1, in + 48) ||
      !fp_from_be48(p.y.c0, in + 96) || !fp_from_be48(p.y.c1, in + 144))
    return -1;
  p.inf = false;
  Jac<Fp2> c;
  clear_cofactor_psi(c, p);
  Aff<Fp2> a;
  jac_to_aff(a, c);
  g2_compress(a, out);
  return 0;
}

// Decompress a pubkey to raw affine bytes (x||y, 48B BE each) for caching —
// the analog of ValidatorPubkeyCache keeping keys decompressed in memory.
extern "C" int bls_pk_decompress(const u8 in[48], u8 out[96]) {
  Aff<Fp> p;
  if (!g1_decompress(p, in) || p.inf) return -1;
  fp_to_be48(p.x, out);
  fp_to_be48(p.y, out + 48);
  return 0;
}

// Batch verification with pre-decompressed pubkeys (96B raw affine each) —
// the hot-path shape: keys come from the cache, signatures from the wire.
extern "C" int bls_verify_signature_sets_raw(u64 n_sets, const u64 *pk_counts,
                                             const u8 *pks_raw, const u8 *msgs,
                                             const u8 *sigs,
                                             const u64 *scalars) {
  if (n_sets == 0) return 0;
  Fp12 f = FP12_ONE;
  Jac<Fp2> sig_acc;
  jac_set_inf(sig_acc);
  u64 pk_off = 0;
  for (u64 i = 0; i < n_sets; i++) {
    Jac<Fp> agg;
    jac_set_inf(agg);
    for (u64 k = 0; k < pk_counts[i]; k++) {
      Aff<Fp> p;
      const u8 *raw = pks_raw + 96 * (pk_off + k);
      if (!fp_from_be48(p.x, raw) || !fp_from_be48(p.y, raw + 48)) return -1;
      p.inf = false;
      Jac<Fp> j;
      jac_from_aff(j, p);
      jac_add(agg, agg, j);
    }
    pk_off += pk_counts[i];
    Aff<Fp> apk;
    jac_to_aff(apk, agg);
    if (apk.inf) return 0;
    Aff<Fp2> sig;
    if (!g2_decompress(sig, sigs + 96 * i)) return -1;
    if (sig.inf || !g2_in_subgroup(sig)) return 0;
    u64 r = scalars[i] ? scalars[i] : 1;
    Jac<Fp2> js, rs;
    jac_from_aff(js, sig);
    jac_mul(rs, js, &r, 64);
    jac_add(sig_acc, sig_acc, rs);
    Jac<Fp> jp, rp;
    jac_from_aff(jp, apk);
    jac_mul(rp, jp, &r, 64);
    Aff<Fp> spk;
    jac_to_aff(spk, rp);
    Aff<Fp2> h;
    hash_to_g2(h, msgs + 32 * i, 32);
    miller_loop_acc(f, spk, h);
  }
  Aff<Fp2> sacc;
  jac_to_aff(sacc, sig_acc);
  miller_loop_acc(f, NEG_G1_GEN, sacc);
  Fp12 r;
  final_exponentiation(r, f);
  return fp12_is_one(r) ? 1 : 0;
}

// Scalar-multiply a compressed G2 point (tests/benches).
extern "C" int bls_g2_mul(const u8 in[96], const u8 sk[32], u8 out[96]) {
  Aff<Fp2> p;
  if (!g2_decompress(p, in)) return -1;
  u64 e[4];
  scalar_from_be32_mod_r(e, sk);
  Jac<Fp2> j, r;
  jac_from_aff(j, p);
  jac_mul(r, j, e, 255);
  Aff<Fp2> a;
  jac_to_aff(a, r);
  g2_compress(a, out);
  return 0;
}
