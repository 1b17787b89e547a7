// Seeded u64 test-vector ORACLE for cross-validating the u32 framework
// against the reference's actual 64-bit arithmetic (VERDICT r3 Missing #1).
//
// Unlike ref_model.cpp (a cost model with random key material, used as the
// measured baseline stopwatch), this program runs the REAL scheme end to
// end at reference parameters and word width:
//
//   keygen (ternary secrets, gaussian errors, KKLSS b/d/v triples over the
//   seeded CRS)  ->  2 parties each encrypt a caller-supplied integer
//   plaintext  ->  KKLSS MulAndRelin of the two single-party ciphertexts
//   (union {A,B}, the general distinct-operand path)  ->  exact decryption
//   c0 + cA*sA + cB*sB  ->  the Q-basis RNS residues written to a file.
//
// The python harness (tests/test_ref_oracle.py) feeds both this oracle and
// the u32 framework the SAME canonical-embedding plaintext integers and
// asserts both decrypt to the product within the reference noise bounds,
// with comparable noise magnitudes — machine-checking that the u32
// limb-pair redesign preserves reference scheme semantics.
//
// Scheme equations mirror mkrlwe/keygen.go:58-187, encryptor.go:55-118,
// keyswitch.go:49-230, basis_extension.go:192-232,442-451 (alpha=1 copy
// fast path), at PN15QP880's literal prime lists
// (mkckks/mkckks_test.go:51-72). A "toy" config (logN=12, 4x~50b Q) gives
// the default test tier a fast run of the same machinery.
//
// Build: g++ -O3 -std=c++17 ref_oracle.cpp -o ref_oracle
// Run:   ./ref_oracle <pn15|toy> <seed> <m0.i64> <m1.i64> <out.bin>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;

// ------------------------------------------------------------- modarith --
static inline u64 addmod(u64 a, u64 b, u64 q) {
    u64 r = a + b;
    return r >= q ? r - q : r;
}
static inline u64 submod(u64 a, u64 b, u64 q) {
    return a >= b ? a - b : a + q - b;
}
static inline u64 mredc(u128 t, u64 q, u64 qinv) {
    u64 m = (u64)t * qinv;
    u128 u = t + (u128)m * q;
    u64 r = (u64)(u >> 64);
    return r >= q ? r - q : r;
}
static inline u64 mmul(u64 a, u64 b, u64 q, u64 qinv) {
    return mredc((u128)a * b, q, qinv);
}
static inline u64 shoup_lazy(u64 a, u64 w, u64 wp, u64 q) {
    u64 hi = (u64)(((u128)a * wp) >> 64);
    return a * w - hi * q;
}
static u64 powmod(u64 b, u64 e, u64 q) {
    u128 r = 1, x = b % q;
    while (e) {
        if (e & 1) r = r * x % q;
        x = x * x % q;
        e >>= 1;
    }
    return (u64)r;
}
static u64 inv_pow2_64(u64 q) {
    u64 inv = q;
    for (int i = 0; i < 6; i++) inv *= 2 - q * inv;
    return ~inv + 1;
}

// ------------------------------------------------------------------ rng --
static u64 rng_state;
static inline u64 rng() {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 7;
    rng_state ^= rng_state << 17;
    return rng_state;
}
static double rng_unit() {  // uniform in (0, 1)
    return ((rng() >> 11) + 0.5) * (1.0 / 9007199254740992.0);
}
static i64 sample_gauss(double sigma) {  // rounded, 6-sigma clamp
    double u1 = rng_unit(), u2 = rng_unit();
    double g = sqrt(-2.0 * log(u1)) * cos(6.283185307179586 * u2) * sigma;
    double b = 6.0 * sigma;
    if (g > b) g = b;
    if (g < -b) g = -b;
    return (i64)llround(g);
}
static i64 sample_ternary() {  // P(0)=1/2, P(+-1)=1/4
    switch (rng() & 3) {
        case 0: return -1;
        case 1: return 1;
        default: return 0;
    }
}

// --------------------------------------------------------------- tables --
struct Limb {
    u64 q, qinv, r2;
    std::vector<u64> psi, psi_sh, ipsi, ipsi_sh;
    u64 ninv, ninv_sh;
};

struct Ctx {
    int logn, n, lq, lp, lqp, beta;
    std::vector<u64> qmod, pmod;       // moduli
    std::vector<Limb> limbs;           // lqp limbs (Q then P)
    std::vector<u64> pinv_q;           // P^{-1} mod q_j (Mont)
    std::vector<std::vector<u64>> phat_q;  // (P/p_i) mod q_j (Mont)
    std::vector<u64> phat_inv;         // (P/p_i)^{-1} mod p_i
    std::vector<double> inv_p;
    std::vector<u64> pmodq_mont;       // P mod q_j, Mont form
};

static u64 find_psi(u64 q, int n) {
    for (u64 g = 2;; g++) {
        if (powmod(g, (q - 1) / 2, q) == q - 1) {
            u64 psi = powmod(g, (q - 1) / (2 * (u64)n), q);
            if (powmod(psi, n, q) == q - 1) return psi;
        }
    }
}

static void init_limb(Limb &L, u64 q, int logn) {
    int n = 1 << logn;
    L.q = q;
    L.qinv = inv_pow2_64(q);
    u64 r = (u64)(((u128)1 << 64) % q);
    L.r2 = (u64)((u128)r * r % q);
    u64 psi = find_psi(q, n), ipsi = powmod(psi, q - 2, q);
    L.psi.resize(n); L.psi_sh.resize(n);
    L.ipsi.resize(n); L.ipsi_sh.resize(n);
    std::vector<u64> fwd(n), inv(n);
    u64 pw = 1, ipw = 1;
    for (int j = 0; j < n; j++) {
        fwd[j] = pw; inv[j] = ipw;
        pw = (u64)((u128)pw * psi % q);
        ipw = (u64)((u128)ipw * ipsi % q);
    }
    for (int j = 0; j < n; j++) {
        int b = 0;
        for (int t = 0; t < logn; t++) b |= ((j >> t) & 1) << (logn - 1 - t);
        L.psi[j] = fwd[b];
        L.psi_sh[j] = (u64)(((u128)fwd[b] << 64) / q);
        L.ipsi[j] = inv[b];
        L.ipsi_sh[j] = (u64)(((u128)inv[b] << 64) / q);
    }
    L.ninv = powmod(n, q - 2, q);
    L.ninv_sh = (u64)(((u128)L.ninv << 64) / q);
}

// lazy CT fwd NTT / GS inv NTT (lattigo-style, see ref_model.cpp)
static void ntt(u64 *a, const Limb &L, int n) {
    const u64 q = L.q, q2 = 2 * q;
    int t = n;
    for (int m = 1; m < n; m <<= 1) {
        t >>= 1;
        for (int i = 0; i < m; i++) {
            u64 s = L.psi[m + i], sp = L.psi_sh[m + i];
            u64 *x = a + 2 * i * t, *y = x + t;
            for (int j = 0; j < t; j++) {
                u64 u = x[j] >= q2 ? x[j] - q2 : x[j];
                u64 v = shoup_lazy(y[j], s, sp, q);
                x[j] = u + v;
                y[j] = u + q2 - v;
            }
        }
    }
    for (int j = 0; j < n; j++) {
        u64 v = a[j] >= q2 ? a[j] - q2 : a[j];
        a[j] = v >= q ? v - q : v;
    }
}
static void intt(u64 *a, const Limb &L, int n) {
    const u64 q = L.q, q2 = 2 * q;
    int t = 1;
    for (int m = n; m > 1; m >>= 1) {
        int h = m >> 1;
        for (int i = 0; i < h; i++) {
            u64 s = L.ipsi[h + i], sp = L.ipsi_sh[h + i];
            u64 *x = a + 2 * i * t, *y = x + t;
            for (int j = 0; j < t; j++) {
                u64 u = x[j], v = y[j];
                u64 w = u + v;
                x[j] = w >= q2 ? w - q2 : w;
                y[j] = shoup_lazy(u + q2 - v, s, sp, q);
            }
        }
        t <<= 1;
    }
    for (int j = 0; j < n; j++) {
        u64 v = shoup_lazy(a[j], L.ninv, L.ninv_sh, q);
        a[j] = v >= q ? v - q : v;
    }
}

// ----------------------------------------------------------------- init --
static void init_ctx(Ctx &C, const std::string &config) {
    if (config == "pn15") {
        // PN15QP880 literal lists (mkckks/mkckks_test.go:51-72)
        C.logn = 15;
        C.qmod = {
            0xfffffffff6a0001ULL,
            0x3fffffffd60001ULL, 0x3fffffffca0001ULL,
            0x3fffffff6d0001ULL, 0x3fffffff5d0001ULL,
            0x3fffffff550001ULL, 0x3fffffff390001ULL,
            0x3fffffff360001ULL, 0x3fffffff2a0001ULL,
            0x3fffffff000001ULL, 0x3ffffffefa0001ULL,
            0x3ffffffef40001ULL, 0x3ffffffed70001ULL,
            0x3ffffffed30001ULL};
        C.pmod = {0x7ffffffffe70001ULL, 0x7ffffffffe10001ULL};
    } else {  // toy: logN=12, 4 x ~50b Q + 2 x ~51b P (runtime search)
        C.logn = 12;
        u64 two_n = 2ULL << C.logn;
        auto next_prime = [&](u64 start) {
            for (u64 k = start / two_n;; k++) {
                u64 cand = k * two_n + 1;
                if (cand < start) continue;
                bool ok = cand % 2 == 1;
                for (u64 d = 3; ok && d * d <= cand; d += 2)
                    if (cand % d == 0) ok = false;
                if (ok) return cand;
            }
        };
        u64 p = 1ULL << 50;
        for (int i = 0; i < 4; i++) {
            p = next_prime(p + 1);
            C.qmod.push_back(p);
        }
        p = 1ULL << 51;
        for (int i = 0; i < 2; i++) {
            p = next_prime(p + 1);
            C.pmod.push_back(p);
        }
    }
    C.n = 1 << C.logn;
    C.lq = (int)C.qmod.size();
    C.lp = (int)C.pmod.size();
    C.lqp = C.lq + C.lp;
    C.beta = C.lq;  // alpha = 1
    C.limbs.resize(C.lqp);
    for (int i = 0; i < C.lq; i++) init_limb(C.limbs[i], C.qmod[i], C.logn);
    for (int i = 0; i < C.lp; i++)
        init_limb(C.limbs[C.lq + i], C.pmod[i], C.logn);
    u128 P = 1;
    for (int i = 0; i < C.lp; i++) P *= C.pmod[i];
    C.pinv_q.resize(C.lq);
    C.pmodq_mont.resize(C.lq);
    for (int j = 0; j < C.lq; j++) {
        u64 q = C.qmod[j];
        u64 pmodq = (u64)(P % q);
        const Limb &L = C.limbs[j];
        C.pinv_q[j] = mmul(powmod(pmodq, q - 2, q), L.r2, q, L.qinv);
        C.pmodq_mont[j] = mmul(pmodq, L.r2, q, L.qinv);
    }
    C.phat_q.assign(C.lp, std::vector<u64>(C.lq));
    C.phat_inv.resize(C.lp);
    C.inv_p.resize(C.lp);
    for (int i = 0; i < C.lp; i++) {
        u128 phat = 1;
        for (int t = 0; t < C.lp; t++)
            if (t != i) phat *= C.pmod[t];
        for (int j = 0; j < C.lq; j++) {
            u64 q = C.qmod[j];
            const Limb &L = C.limbs[j];
            C.phat_q[i][j] = mmul((u64)(phat % q), L.r2, q, L.qinv);
        }
        C.phat_inv[i] = powmod((u64)(phat % C.pmod[i]),
                               C.pmod[i] - 2, C.pmod[i]);
        C.inv_p[i] = 1.0 / (double)C.pmod[i];
    }
}

// ------------------------------------------------------- poly utilities --
typedef std::vector<u64> Poly;  // L limbs x N, limb-major

static size_t PN(const Ctx &C) { return (size_t)C.n; }

static Poly lift_signed(const std::vector<i64> &s, const Ctx &C, int L,
                        int off = 0) {
    Poly p((size_t)L * C.n);
    for (int l = 0; l < L; l++) {
        u64 q = C.limbs[off + l].q;
        for (int j = 0; j < C.n; j++) {
            i64 v = s[j];
            p[(size_t)l * C.n + j] = v >= 0 ? (u64)v % q
                                            : q - ((u64)(-v) % q);
        }
    }
    return p;
}

static void ntt_all(Poly &p, const Ctx &C, int L, int off = 0) {
    for (int l = 0; l < L; l++)
        ntt(p.data() + (size_t)l * C.n, C.limbs[off + l], C.n);
}
static void intt_all(Poly &p, const Ctx &C, int L, int off = 0) {
    for (int l = 0; l < L; l++)
        intt(p.data() + (size_t)l * C.n, C.limbs[off + l], C.n);
}
static void mform_all(u64 *p, const Ctx &C, int L, int off = 0) {
    for (int l = 0; l < L; l++) {
        const Limb &Lb = C.limbs[off + l];
        u64 *x = p + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++)
            x[j] = mmul(x[j], Lb.r2, Lb.q, Lb.qinv);
    }
}
static void mul_mont_add(const u64 *a, const u64 *b, u64 *acc, const Ctx &C,
                         int L, int off = 0) {
    for (int l = 0; l < L; l++) {
        const Limb &Lb = C.limbs[off + l];
        const u64 *x = a + (size_t)l * C.n, *y = b + (size_t)l * C.n;
        u64 *z = acc + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++)
            z[j] = addmod(z[j], mmul(x[j], y[j], Lb.q, Lb.qinv), Lb.q);
    }
}
static void mul_mont(const u64 *a, const u64 *b, u64 *out, const Ctx &C,
                     int L, int off = 0) {
    for (int l = 0; l < L; l++) {
        const Limb &Lb = C.limbs[off + l];
        const u64 *x = a + (size_t)l * C.n, *y = b + (size_t)l * C.n;
        u64 *z = out + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++)
            z[j] = mmul(x[j], y[j], Lb.q, Lb.qinv);
    }
}
static void add_inplace(u64 *a, const u64 *b, const Ctx &C, int L,
                        int off = 0) {
    for (int l = 0; l < L; l++) {
        u64 q = C.limbs[off + l].q;
        u64 *x = a + (size_t)l * C.n;
        const u64 *y = b + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++) x[j] = addmod(x[j], y[j], q);
    }
}
static void sub_inplace(u64 *a, const u64 *b, const Ctx &C, int L,
                        int off = 0) {
    for (int l = 0; l < L; l++) {
        u64 q = C.limbs[off + l].q;
        u64 *x = a + (size_t)l * C.n;
        const u64 *y = b + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++) x[j] = submod(x[j], y[j], q);
    }
}
static void neg_inplace(u64 *a, const Ctx &C, int L, int off = 0) {
    for (int l = 0; l < L; l++) {
        u64 q = C.limbs[off + l].q;
        u64 *x = a + (size_t)l * C.n;
        for (int j = 0; j < C.n; j++) x[j] = x[j] ? q - x[j] : 0;
    }
}

static Poly gaussian_ntt_mont(const Ctx &C, int L, double sigma) {
    std::vector<i64> e(C.n);
    for (int j = 0; j < C.n; j++) e[j] = sample_gauss(sigma);
    Poly p = lift_signed(e, C, L);
    ntt_all(p, C, L);
    mform_all(p.data(), C, L);
    return p;
}

static Poly uniform_ntt_mont(const Ctx &C, int L) {
    Poly p((size_t)L * C.n);
    for (int l = 0; l < L; l++) {
        u64 q = C.limbs[l].q;
        for (int j = 0; j < C.n; j++)
            p[(size_t)l * C.n + j] = rng() % q;
    }
    return p;
}

// ----------------------------------------------------------- scheme ops --
// HPS exact ModDown QP->Q (basis_extension.go:192-232)
static void mod_down(const u64 *xqp, u64 *out, const Ctx &C) {
    const u64 *xp = xqp + (size_t)C.lq * C.n;
    std::vector<u64> y((size_t)C.lp * C.n);
    for (int i = 0; i < C.lp; i++) {
        const Limb &pl = C.limbs[C.lq + i];
        const u64 *src = xp + (size_t)i * C.n;
        u64 *dst = y.data() + (size_t)i * C.n;
        for (int j = 0; j < C.n; j++)
            dst[j] = mmul(mmul(src[j], pl.r2, pl.q, pl.qinv),
                          C.phat_inv[i], pl.q, pl.qinv);
    }
    u128 P = 1;
    for (int i = 0; i < C.lp; i++) P *= C.pmod[i];
    for (int jl = 0; jl < C.lq; jl++) {
        const Limb &L = C.limbs[jl];
        const u64 q = L.q, qinv = L.qinv;
        const u64 *xq = xqp + (size_t)jl * C.n;
        u64 *o = out + (size_t)jl * C.n;
        u64 Pmod = (u64)(P % q);
        for (int j = 0; j < C.n; j++) {
            double vf = 0;
            u64 acc0 = 0;
            for (int i = 0; i < C.lp; i++) {
                u64 yi = y[(size_t)i * C.n + j];
                vf += (double)yi * C.inv_p[i];
                acc0 = addmod(acc0, mmul(yi, C.phat_q[i][jl], q, qinv), q);
            }
            u64 v = (u64)vf;
            u64 corr = (u64)(((u128)v * Pmod) % q);
            u64 conv = submod(acc0, corr, q);
            o[j] = mmul(submod(xq[j], conv, q), C.pinv_q[jl], q, qinv);
        }
    }
}

// Gadget decompose + NTT (alpha=1 copy fast path) -> (beta, Lqp, N) NTT
static void decompose_ntt(const u64 *x, u64 *digits, const Ctx &C) {
    for (int d = 0; d < C.beta; d++) {
        const u64 *src = x + (size_t)d * C.n;
        u64 *dst = digits + (size_t)d * C.lqp * C.n;
        for (int l = 0; l < C.lqp; l++) {
            const u64 q = C.limbs[l].q;
            u64 *o = dst + (size_t)l * C.n;
            if (l == d) memcpy(o, src, sizeof(u64) * C.n);
            else for (int j = 0; j < C.n; j++) o[j] = src[j] % q;
            ntt(o, C.limbs[l], C.n);
        }
    }
}

// beta x Lqp contraction + iNTT + ModDown
static void external_product(const u64 *digits, const u64 *key, u64 *out_q,
                             const Ctx &C) {
    std::vector<u64> acc((size_t)C.lqp * C.n, 0);
    for (int d = 0; d < C.beta; d++)
        mul_mont_add(digits + (size_t)d * C.lqp * C.n,
                     key + (size_t)d * C.lqp * C.n, acc.data(), C, C.lqp);
    for (int l = 0; l < C.lqp; l++)
        intt(acc.data() + (size_t)l * C.n, C.limbs[l], C.n);
    mod_down(acc.data(), out_q, C);
}

// swk(sk_in) = e + g*sk_in: digit i adds P*sk_in on Q limb i (alpha=1)
static Poly gen_switching_key(const Poly &sk_mont, const Ctx &C,
                              double sigma) {
    size_t dig = (size_t)C.lqp * C.n;
    Poly swk((size_t)C.beta * dig);
    for (int d = 0; d < C.beta; d++) {
        Poly e = gaussian_ntt_mont(C, C.lqp, sigma);
        memcpy(swk.data() + (size_t)d * dig, e.data(), sizeof(u64) * dig);
        // += P * s on Q limb d
        const Limb &L = C.limbs[d];
        u64 *o = swk.data() + (size_t)d * dig + (size_t)d * C.n;
        const u64 *s = sk_mont.data() + (size_t)d * C.n;
        for (int j = 0; j < C.n; j++)
            o[j] = addmod(o[j], mmul(s[j], C.pmodq_mont[d], L.q, L.qinv),
                          L.q);
    }
    return swk;
}

struct Party {
    Poly sk;           // (Lqp, N) NTT+Mont
    Poly pk0, pk1;     // (Lqp, N) NTT+Mont
    Poly kb, kd, kv;   // (beta, Lqp, N) NTT+Mont
};

static Party gen_party(const Poly &crs_a, const Poly &crs_u, const Ctx &C,
                       double sigma) {
    Party P;
    std::vector<i64> s(C.n);
    for (int j = 0; j < C.n; j++) s[j] = sample_ternary();
    P.sk = lift_signed(s, C, C.lqp);
    ntt_all(P.sk, C, C.lqp);
    mform_all(P.sk.data(), C, C.lqp);

    size_t dig = (size_t)C.lqp * C.n;
    // pk = (e - a0*s, a0), a0 = crs_a digit 0
    P.pk1.assign(crs_a.begin(), crs_a.begin() + dig);
    P.pk0 = gaussian_ntt_mont(C, C.lqp, sigma);
    {
        Poly as(dig, 0);
        mul_mont_add(P.pk1.data(), P.sk.data(), as.data(), C, C.lqp);
        sub_inplace(P.pk0.data(), as.data(), C, C.lqp);
    }
    // r: the shared-secret for d/v (gen fresh ternary like the Go tests)
    std::vector<i64> rr(C.n);
    for (int j = 0; j < C.n; j++) rr[j] = sample_ternary();
    Poly r = lift_signed(rr, C, C.lqp);
    ntt_all(r, C, C.lqp);
    mform_all(r.data(), C, C.lqp);

    // b = e - a*s   (per digit)
    P.kb.resize((size_t)C.beta * dig);
    for (int d = 0; d < C.beta; d++) {
        Poly e = gaussian_ntt_mont(C, C.lqp, sigma);
        Poly as(dig, 0);
        mul_mont_add(crs_a.data() + (size_t)d * dig, P.sk.data(),
                     as.data(), C, C.lqp);
        sub_inplace(e.data(), as.data(), C, C.lqp);
        memcpy(P.kb.data() + (size_t)d * dig, e.data(), sizeof(u64) * dig);
    }
    // d = swk(s) - a*r
    P.kd = gen_switching_key(P.sk, C, sigma);
    for (int d = 0; d < C.beta; d++) {
        Poly ar(dig, 0);
        mul_mont_add(crs_a.data() + (size_t)d * dig, r.data(), ar.data(),
                     C, C.lqp);
        sub_inplace(P.kd.data() + (size_t)d * dig, ar.data(), C, C.lqp);
    }
    // v = -(u*s + swk(r))
    P.kv = gen_switching_key(r, C, sigma);
    for (int d = 0; d < C.beta; d++) {
        Poly us(dig, 0);
        mul_mont_add(crs_u.data() + (size_t)d * dig, P.sk.data(),
                     us.data(), C, C.lqp);
        add_inplace(P.kv.data() + (size_t)d * dig, us.data(), C, C.lqp);
        neg_inplace(P.kv.data() + (size_t)d * dig, C, C.lqp);
    }
    return P;
}

// encrypt integer plaintext m (coeff domain over Q): ct = (u*pk0+e0+m,
// u*pk1+e1), coeff-domain output (encryptor.go:95-112)
static void encrypt(const std::vector<i64> &m, const Party &P, const Ctx &C,
                    double sigma, Poly &c0, Poly &c1) {
    std::vector<i64> u(C.n), e0(C.n), e1(C.n);
    for (int j = 0; j < C.n; j++) u[j] = sample_ternary();
    for (int j = 0; j < C.n; j++) e0[j] = sample_gauss(sigma);
    for (int j = 0; j < C.n; j++) e1[j] = sample_gauss(sigma);
    Poly un = lift_signed(u, C, C.lq);
    ntt_all(un, C, C.lq);
    size_t pq = (size_t)C.lq * C.n;
    c0.assign(pq, 0); c1.assign(pq, 0);
    mul_mont_add(un.data(), P.pk0.data(), c0.data(), C, C.lq);  // pk Q-limbs
    mul_mont_add(un.data(), P.pk1.data(), c1.data(), C, C.lq);
    intt_all(c0, C, C.lq);
    intt_all(c1, C, C.lq);
    Poly e0p = lift_signed(e0, C, C.lq), e1p = lift_signed(e1, C, C.lq);
    Poly mp = lift_signed(m, C, C.lq);
    add_inplace(c0.data(), e0p.data(), C, C.lq);
    add_inplace(c0.data(), mp.data(), C, C.lq);
    add_inplace(c1.data(), e1p.data(), C, C.lq);
}

int main(int argc, char **argv) {
    if (argc < 6) {
        fprintf(stderr,
                "usage: ref_oracle <pn15|toy> <seed> <m0> <m1> <out>\n");
        return 2;
    }
    std::string config = argv[1];
    rng_state = strtoull(argv[2], nullptr, 0) * 0x9e3779b97f4a7c15ULL
                + 0x2545f4914f6cdd1dULL;
    Ctx C;
    init_ctx(C, config);
    const double SIGMA = 3.2;
    size_t pq = (size_t)C.lq * C.n, dig = (size_t)C.lqp * C.n;
    size_t DIG = (size_t)C.beta * dig;

    auto read_m = [&](const char *path) {
        std::vector<i64> m(C.n);
        FILE *f = fopen(path, "rb");
        if (!f || fread(m.data(), sizeof(i64), C.n, f) != (size_t)C.n) {
            fprintf(stderr, "bad plaintext file %s\n", path);
            exit(2);
        }
        fclose(f);
        return m;
    };
    std::vector<i64> m0 = read_m(argv[3]), m1 = read_m(argv[4]);

    // CRS (NTT+Mont by convention): a (beta digits), u (beta digits)
    Poly crs_a((size_t)C.beta * dig), crs_u((size_t)C.beta * dig);
    for (int d = 0; d < C.beta; d++) {
        Poly t = uniform_ntt_mont(C, C.lqp);
        memcpy(crs_a.data() + (size_t)d * dig, t.data(),
               sizeof(u64) * dig);
        t = uniform_ntt_mont(C, C.lqp);
        memcpy(crs_u.data() + (size_t)d * dig, t.data(),
               sizeof(u64) * dig);
    }
    Party A = gen_party(crs_a, crs_u, C, SIGMA);
    Party B = gen_party(crs_a, crs_u, C, SIGMA);

    Poly c0a, c1a, c0b, c1b;
    encrypt(m0, A, C, SIGMA, c0a, c1a);
    encrypt(m1, B, C, SIGMA, c0b, c1b);

    // ---- KKLSS MulAndRelin, ids0={A}, ids1={B} (keyswitch.go:122-230) --
    std::vector<u64> dec0(DIG), dec1(DIG), dect(DIG);
    decompose_ntt(c1a.data(), dec0.data(), C);   // ct0's party-A poly
    decompose_ntt(c1b.data(), dec1.data(), C);   // ct1's party-B poly

    // x = MForm(dec0 . d_A), y = MForm(dec1 . b_B)
    std::vector<u64> x(DIG, 0), y(DIG, 0);
    for (int d = 0; d < C.beta; d++) {
        mul_mont_add(dec0.data() + (size_t)d * dig,
                     A.kd.data() + (size_t)d * dig,
                     x.data() + (size_t)d * dig, C, C.lqp);
        mul_mont_add(dec1.data() + (size_t)d * dig,
                     B.kb.data() + (size_t)d * dig,
                     y.data() + (size_t)d * dig, C, C.lqp);
    }
    for (int d = 0; d < C.beta; d++) {
        mform_all(x.data() + (size_t)d * dig, C, C.lqp);
        mform_all(y.data() + (size_t)d * dig, C, C.lqp);
    }

    // tensor terms over Q: out0 = c0a*c0b; outA = c1a*c0b; outB = c0a*c1b
    Poly n0a = c0a, n1a = c1a, n0b = c0b, n1b = c1b;
    ntt_all(n0a, C, C.lq); ntt_all(n1a, C, C.lq);
    ntt_all(n0b, C, C.lq); ntt_all(n1b, C, C.lq);
    Poly n0am = n0a, n0bm = n0b;
    mform_all(n0am.data(), C, C.lq);
    mform_all(n0bm.data(), C, C.lq);
    Poly out0(pq), outA(pq), outB(pq);
    mul_mont(n0am.data(), n0b.data(), out0.data(), C, C.lq);
    mul_mont(n1a.data(), n0bm.data(), outA.data(), C, C.lq);
    mul_mont(n1b.data(), n0am.data(), outB.data(), C, C.lq);
    intt_all(out0, C, C.lq);
    intt_all(outA, C, C.lq);
    intt_all(outB, C, C.lq);

    // outB += Ext(dec1, x)
    Poly ext(pq);
    external_product(dec1.data(), x.data(), ext.data(), C);
    add_inplace(outB.data(), ext.data(), C, C.lq);

    // t = Ext(dec0, y); out0 += Ext(dec t, v_A); outA += Ext(dec t, u)
    Poly t(pq);
    external_product(dec0.data(), y.data(), t.data(), C);
    decompose_ntt(t.data(), dect.data(), C);
    external_product(dect.data(), A.kv.data(), ext.data(), C);
    add_inplace(out0.data(), ext.data(), C, C.lq);
    external_product(dect.data(), crs_u.data(), ext.data(), C);
    add_inplace(outA.data(), ext.data(), C, C.lq);

    // ---- exact decryption: m_out = out0 + outA*sA + outB*sB ------------
    Poly dec_acc = out0;
    {
        Poly ta = outA;
        ntt_all(ta, C, C.lq);
        Poly prod(pq);
        mul_mont(ta.data(), A.sk.data(), prod.data(), C, C.lq);
        intt_all(prod, C, C.lq);
        add_inplace(dec_acc.data(), prod.data(), C, C.lq);
        Poly tb = outB;
        ntt_all(tb, C, C.lq);
        mul_mont(tb.data(), B.sk.data(), prod.data(), C, C.lq);
        intt_all(prod, C, C.lq);
        add_inplace(dec_acc.data(), prod.data(), C, C.lq);
    }

    // ---- output: header + moduli + decrypted residues ------------------
    FILE *f = fopen(argv[5], "wb");
    if (!f) { fprintf(stderr, "cannot open %s\n", argv[5]); return 2; }
    int32_t hdr[4] = {(int32_t)C.logn, (int32_t)C.lq, (int32_t)C.lp, 0};
    fwrite(hdr, sizeof(int32_t), 4, f);
    fwrite(C.qmod.data(), sizeof(u64), C.lq, f);
    fwrite(C.pmod.data(), sizeof(u64), C.lp, f);
    fwrite(dec_acc.data(), sizeof(u64), pq, f);
    fclose(f);

    u64 checksum = 0;
    for (size_t j = 0; j < pq; j += 4097) checksum ^= dec_acc[j];
    printf("{\"config\": \"%s\", \"logn\": %d, \"lq\": %d, "
           "\"checksum\": %llu}\n", config.c_str(), C.logn, C.lq,
           (unsigned long long)checksum);
    return 0;
}
