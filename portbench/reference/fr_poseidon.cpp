// BN254 Fr Montgomery arithmetic + Poseidon permutation (host side).
//
// Native equivalent of the reference's ffiasm-generated field library
// (reference: tools/helpers/actions.js:207-229 builds fr.asm with nasm)
// for the *host* half of the framework: the batch builder's sequential
// SMT root chain is Poseidon-bound, and Python bigints are ~100x slower
// than 4x64-limb Montgomery with __int128. The TPU compute path uses the
// limb kernels in circuits_tpu/field; this library only serves host code
// (builder, oracle checks) via ctypes.
//
// Round constants / MDS matrices are NOT hardcoded here: Python generates
// them (Grain LFSR, circuits_tpu/ops/poseidon_constants.py) and installs
// them in Montgomery form via set_poseidon_params().

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// BN254 scalar field modulus, little-endian 64-bit limbs
static const u64 Pl[4] = {
    0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
    0xb85045b68181585dULL, 0x30644e72e131a029ULL};
// -p^{-1} mod 2^64
static const u64 N0 = 0xc2e1f593efffffffULL;
// R^2 mod p (R = 2^256)
static const u64 R2l[4] = {
    0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
    0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
// R mod p (Montgomery one)
static const u64 R1l[4] = {
    0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
    0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL};

struct Fe { u64 v[4]; };

static inline bool geq(const u64* a, const u64* b) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;  // equal
}

static inline void sub4(u64* r, const u64* a, const u64* b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void add_mod(u64* r, const u64* a, const u64* b) {
    u128 carry = 0;
    u64 t[5];
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    t[4] = (u64)carry;
    if (t[4] || geq(t, Pl)) {
        sub4(r, t, Pl);
    } else {
        memcpy(r, t, 32);
    }
}

// CIOS Montgomery multiplication: r = a*b*R^-1 mod p
static void mont_mul(u64* r, const u64* a, const u64* b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)a[j] * b[i] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * N0;
        carry = ((u128)t[0] + (u128)m * Pl[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * Pl[j] + carry;
            t[j - 1] = (u64)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[4] + carry;
        t[3] = (u64)s;
        t[4] = t[5] + (u64)(s >> 64);
    }
    if (t[4] || geq(t, Pl)) {
        sub4(r, t, Pl);
    } else {
        memcpy(r, t, 32);
    }
}

static inline void to_mont(u64* r, const u64* a) { mont_mul(r, a, R2l); }
static inline void from_mont(u64* r, const u64* a) {
    u64 one[4] = {1, 0, 0, 0};
    mont_mul(r, a, one);
}

static inline void pow5(u64* r, const u64* a) {
    u64 a2[4], a4[4];
    mont_mul(a2, a, a);
    mont_mul(a4, a2, a2);
    mont_mul(r, a4, a);
}

// ---------------------------------------------------------------------
// Poseidon parameters (installed from Python, Montgomery form)
// ---------------------------------------------------------------------

static const int MAX_T = 18;
static u64* g_C[MAX_T + 1];   // (rf+rp)*t constants
static u64* g_M[MAX_T + 1];   // t*t MDS
static int g_rp[MAX_T + 1];
static const int RF = 8;

extern "C" void set_poseidon_params(int t, int rp, const u64* C,
                                    const u64* M) {
    if (t < 2 || t > MAX_T) return;
    int nc = (RF + rp) * t;
    delete[] g_C[t];
    delete[] g_M[t];
    g_C[t] = new u64[nc * 4];
    g_M[t] = new u64[t * t * 4];
    memcpy(g_C[t], C, (size_t)nc * 32);
    memcpy(g_M[t], M, (size_t)t * t * 32);
    g_rp[t] = rp;
}

// state: t elements in Montgomery form, updated in place
static void poseidon_permute(int t, u64* state) {
    const u64* C = g_C[t];
    const u64* M = g_M[t];
    int rp = g_rp[t];
    int nrounds = RF + rp;
    u64 ns[MAX_T][4];
    for (int r = 0; r < nrounds; ++r) {
        for (int i = 0; i < t; ++i)
            add_mod(state + 4 * i, state + 4 * i, C + 4 * (r * t + i));
        bool full = (r < RF / 2) || (r >= RF / 2 + rp);
        if (full) {
            for (int i = 0; i < t; ++i)
                pow5(state + 4 * i, state + 4 * i);
        } else {
            pow5(state, state);
        }
        for (int i = 0; i < t; ++i) {
            u64 acc[4] = {0, 0, 0, 0};
            for (int j = 0; j < t; ++j) {
                u64 prod[4];
                mont_mul(prod, M + 4 * (i * t + j), state + 4 * j);
                add_mod(acc, acc, prod);
            }
            memcpy(ns[i], acc, 32);
        }
        memcpy(state, ns, (size_t)t * 32);
    }
}

// inputs: n = t-1 canonical elements (4 limbs LE each); out: canonical
extern "C" void poseidon_hash(int t, const u64* inputs, u64* out) {
    u64 state[MAX_T * 4];
    memset(state, 0, 32);  // state[0] = 0
    for (int i = 1; i < t; ++i)
        to_mont(state + 4 * i, inputs + 4 * (i - 1));
    poseidon_permute(t, state);
    from_mont(out, state);
}
