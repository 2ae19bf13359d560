// K3: the EdDSA-Poseidon group check S * B8 == R8 + hm * A on BabyJubJub,
// batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_eddsa.py
// (`_compiled` -> pallas_call of `_kernel`, entry `eddsa_ok_mont`), with
// the same algorithm: projective twisted-Edwards coordinates in Montgomery
// form, unified add add-2008-bbjlp and doubling dbl-2008-bbjlp.
//  * fixed base S * B8: 4-bit comb over the 64 x 16 affine table of
//    d * 16^j * B8, one mixed add per window;
//  * variable base hm * A: a 16-entry table of d * A, then 64 windows of 4
//    doublings and 1 add, most significant window first;
//  * the final check is projective (X1 Z2 == X2 Z1, Y1 Z2 == Y2 Z1).
// S is read as 253 bits (circomlib's Num2Bits(253) on S, and the XLA path
// of the JAX package): the top window of S keeps only bit 252.
//
// What bounds it on the card: operations, some 3,400 Montgomery products a
// lane; and, at the main path's 2,048 lanes, the length of one lane's chain
// of dependent products, since so few lanes leave a scheduler one warp and
// a warp runs one product's carry chain at a time. The first version of
// this kernel walked all products of a lane one after another in one
// thread; but the formulas are far shallower than they are long, and the
// fixed-base walk depends on nothing in the variable-base walk, so this one
// spreads a lane over four threads (Design, below).
//
// The curve in its a = 1 form. a = 168700 is a square mod p, and
// (x, y) -> (x' = sqrt(a) x, y) carries a x^2 + y^2 = 1 + d x^2 y^2 to
// x'^2 + y^2 = 1 + d' x'^2 y^2 with d' = d / a (no square: the law stays
// complete). The bbjlp formulas commute with the map as polynomial
// identities in X, Y, Z -- X1' X2' is the twisted form's a * (X1 X2), d' C' D
// its d C D, and X3 only picks up the factor sqrt(a) -- so every Y and Z the
// kernel forms is the plain version's, every X is sqrt(a) times it, for
// every input, on the curve or not, and the projective comparison gives the
// same verdict. What it buys: the product a * C leaves the doubling, which
// is then 7 products and 2 deep (8 and 3 before). The kernel maps Ax and
// R8x on entry (one product each); the comb table comes mapped from the host
// (convert.eddsa_kernel_words), with a third column d' x' y that makes the
// mixed add 4 deep: E = d' C D = (FX FY)(d' px' py).
//
// Design: 4 threads a lane (a group), 8 lanes a warp, one warp a block.
// The group runs one instruction stream; a STEP is one fr_mont_mul in every
// thread, on operands chosen by selects, and values travel between the
// threads of a group by warp shuffles. Thread c < 3 of a group holds
// coordinate c (X, Y, Z) of the variable-base sum; thread 3 holds all of
// the fixed-base sum (FX, FY, FZ). Which product runs on which thread
// (tests/test_torch_eddsa.py mirrors this table in Python integers):
//
//   doubling k = 0..3 of a window
//                   thread 0     thread 1      thread 2     thread 3
//     D1            M = X Y      D = Y Y       H = Z Z      C = X X
//        F = C + D, G = C - D, J = F - 2 H        [2 M = (X + Y)^2 - C - D]
//     D2            X' = 2M J    Y' = F G      Z' = F J     fixed-base add:
//                          k = 0: C_f = FX px, 1: D_f = FY py, 2: B_f = FZ FZ,
//                          3: W_f = FX FY
//   add of (X2, Y2, Z2, S2 = X2 + Y2), after thread 3 got S1 = X1 + Y1
//     A1            C = X1 X2    D = Y1 Y2     A = Z1 Z2    T = S1 S2
//     A2            CD = C D     T_f = (FX + FY)(px + py)
//                                              B = A A      E_f = W_f kc
//     A3            E = d' CD    AF_f = FZ F_f AG_f = FZ G_f  Z'_f = F_f G_f
//        F = B - E, G = B + E, U = T - C - D, V = D - C (and so for _f)
//     A4            AF = A F     AG = A G      Z' = F G     X'_f = AF_f U_f
//     A5            X' = AF U    Y' = AG V     Y'_f = AG_f V_f
//   (px, py, kc = d' px py: the window's comb entry. In the adds that build
//   the table and in the add of R8 the fixed-base slots idle.)
//
// A window is 4 x 2 + 5 = 13 steps where one thread a lane walks 51
// products; a lane is 1 (Ax) + 14 x 5 (table) + 64 x 13 + 1 (R8x) + 5 (the
// add of R8) + 1 (the comparison's four products) = 910 steps. A mixed add
// (Z2 = 1) runs as a unified add on Z2 = 1: thread 2 would idle in A1
// otherwise, and Z1 * 1 is Z1 exactly.
//
// The table of d * A lives in shared memory, 16 KiB a warp: entry d holds
// X, Y, Z and S = X + Y, thread c of a group stores and loads column c,
// and a word sits at ((d * 8 + word) * 4 + c) * 8 + lane, so the 32
// threads of a warp hit 32 different banks whatever their lanes' digits.
// Only its own warp reads a warp's table: no block barrier.
// The 96 KiB comb block stays in global memory, cached by L1/L2; an element
// is fetched a product before it is used, the next window's digits a
// window ahead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "funcs.cuh"
#include "poseidon.cuh"

using namespace ctpu;

constexpr int K3_GROUP = 4;                         // threads a lane
constexpr int K3_THREADS = 32;                      // one warp a block
constexpr int K3_LANES = K3_THREADS / K3_GROUP;     // lanes a block
constexpr int K3_TAB_WORDS = 16 * 8 * 4 * K3_LANES;  // 16 entries x 4 columns

// v of group thread `src` (one source for the whole group).
__device__ __forceinline__ void k3_bcast(uint32_t r[8], const uint32_t v[8], int gbase,
                                         int src) {
  fr_shfl(r, v, gbase + src);
}

// Thread 3 of the group: v = X + Y of the point whose X and Y threads 0 and
// 1 hold. The other threads keep their v.
__device__ __forceinline__ void k3_sum_xy(uint32_t v[8], int i, int gbase) {
  uint32_t x[8], y[8];
  k3_bcast(x, v, gbase, 0);
  k3_bcast(y, v, gbase, 1);
  fr_add(x, x, y);
  fr_select(v, i == 3, x, v);
}

// What the fixed-base mixed add keeps between its steps; thread 3's copy
// is the one that counts.
struct K3Fix {
  uint32_t x[8], y[8], z[8];  // the sum FX, FY, FZ
  uint32_t c[8], d[8], b[8], w[8];  // C_f, D_f, B_f, W_f of this window
  uint32_t ps[8], kc[8];  // px + py and d' px py of the window's comb entry
};

// Unified add, steps A1-A5, in the a = 1 form. v: thread c holds X1, Y1,
// Z1, S1 = X1 + Y1; q: X2, Y2, Z2, S2 likewise; kd is d'. On return threads
// 0..2 hold X', Y', Z' in v (thread 3's v is undefined). With FIX the
// fixed-base mixed add's last seven products ride in the free slots and
// fix.x, fix.y, fix.z become the new sum.
template <bool FIX>
__device__ __forceinline__ void k3_add(uint32_t v[8], const uint32_t q[8],
                                       const uint32_t kd[8], K3Fix& fix, int i,
                                       int gbase) {
  uint32_t p1[8], p2[8], p3[8], p4[8], sw[8], a[8], b[8], f[8], g[8], t[8];
  fr_mont_mul(p1, v, q);  // A1: C, D, A, T
  // A2: thread 0 C * D, thread 2 A * A
  fr_shfl(sw, p1, gbase + (i < 2 ? (i ^ 1) : i));
  fr_copy(a, p1);
  fr_select(b, i == 0, sw, p1);
  if constexpr (FIX) {  // thread 1 (FX + FY)(px + py), thread 3 W_f * kc
    fr_add(t, fix.x, fix.y);
    k3_bcast(t, t, gbase, 3);
    fr_select(a, i == 1, t, a);
    fr_select(a, i == 3, fix.w, a);
    fr_select(b, i == 1, fix.ps, b);
    fr_select(b, i == 3, fix.kc, b);
  }
  fr_mont_mul(p2, a, b);  // CD, T_f, B, E_f
  // A3: thread 0 CD * d'
  fr_copy(a, p2);
  fr_copy(b, kd);
  if constexpr (FIX) {  // thread 1 FZ * F_f, thread 2 FZ * G_f, thread 3 F_f * G_f
    uint32_t fz[8];
    fr_sub(f, fix.b, p2);
    fr_add(g, fix.b, p2);
    k3_bcast(f, f, gbase, 3);
    k3_bcast(g, g, gbase, 3);
    k3_bcast(fz, fix.z, gbase, 3);
    fr_select(a, i == 0, a, fz);
    fr_select(a, i == 3, f, a);
    fr_select(b, i == 1, f, g);
    fr_select(b, i == 0, kd, b);
  }
  fr_mont_mul(p3, a, b);  // E, AF_f, AG_f, Z'_f
  // F = B - E, G = B + E in every thread
  k3_bcast(a, p2, gbase, 2);
  k3_bcast(b, p3, gbase, 0);
  fr_sub(f, a, b);
  fr_add(g, a, b);
  // A4: thread 0 A * F, thread 1 A * G, thread 2 F * G
  k3_bcast(t, p1, gbase, 2);
  fr_select(a, i == 2, f, t);
  fr_select(b, i == 0, f, g);
  if constexpr (FIX) {  // thread 3 AF_f * U_f, U_f = T_f - C_f - D_f
    uint32_t u[8];
    k3_bcast(t, p3, gbase, 1);
    k3_bcast(u, p2, gbase, 1);
    fr_sub(u, u, fix.c);
    fr_sub(u, u, fix.d);
    fr_select(a, i == 3, t, a);
    fr_select(b, i == 3, u, b);
  }
  fr_mont_mul(p4, a, b);  // AF, AG, Z', X'_f
  // A5: thread 0 AF * U, U = T - C - D; thread 1 AG * V, V = D - C
  k3_bcast(a, p1, gbase, 3);
  k3_bcast(b, p1, gbase, 1);
  fr_sub(a, a, p1);
  fr_sub(a, a, b);
  fr_sub(b, p1, sw);
  fr_select(b, i == 0, a, b);
  fr_copy(a, p4);
  if constexpr (FIX) {  // thread 2 AG_f * V_f, V_f = D_f - C_f
    fr_sub(t, fix.d, fix.c);
    k3_bcast(t, t, gbase, 3);
    fr_select(a, i == 2, p3, a);
    fr_select(b, i == 2, t, b);
  }
  fr_mont_mul(p2, a, b);  // X', Y', Y'_f, -
  fr_select(v, i == 2, p4, p2);
  if constexpr (FIX) {
    fr_copy(fix.x, p4);
    k3_bcast(fix.y, p2, gbase, 2);
    fr_copy(fix.z, p3);
  }
}

// Column c = i of table entry d, lane `ln` of the warp.
__device__ __forceinline__ void k3_tab_store(uint32_t* tab, int d, int i, int ln,
                                             const uint32_t v[8]) {
#pragma unroll
  for (int w = 0; w < 8; w++) tab[((d * 8 + w) * 4 + i) * K3_LANES + ln] = v[w];
}

__device__ __forceinline__ void k3_tab_load(uint32_t v[8], const uint32_t* tab, int d,
                                            int i, int ln) {
#pragma unroll
  for (int w = 0; w < 8; w++) v[w] = tab[((d * 8 + w) * 4 + i) * K3_LANES + ln];
}

__device__ __forceinline__ uint32_t nibble(const int64_t* __restrict__ x, int jj,
                                           int64_t b, int64_t B) {
  return ((uint32_t)x[(int64_t)(jj >> 2) * B + b] >> ((jj & 3) * 4)) & 15u;
}

// Thread c of a group: column c of the affine point (x, y) as an addend:
// x, y, 1, x + y.
__device__ __forceinline__ void k3_affine(uint32_t q[8], const uint32_t x[8],
                                          const uint32_t y[8], int i) {
  const uint32_t one[8] = CTPU_MONT_ONE;
  fr_add(q, x, y);
  fr_select(q, i == 2, one, q);
  fr_select(q, i == 1, y, q);
  fr_select(q, i == 0, x, q);
}

constexpr int K3_COMB_ELEMS = 64 * 16 * 3;  // then sqrt(a) and d'

__global__ void __launch_bounds__(K3_THREADS)
eddsa_kernel(const int64_t* __restrict__ ax_m, const int64_t* __restrict__ ay_m,
             const int64_t* __restrict__ s, const int64_t* __restrict__ r8x_m,
             const int64_t* __restrict__ r8y_m, const int64_t* __restrict__ hm,
             const uint32_t* __restrict__ comb, uint8_t* __restrict__ ok, int64_t B) {
  __shared__ uint32_t tab[K3_TAB_WORDS];
  const int i = threadIdx.x & (K3_GROUP - 1), ln = threadIdx.x / K3_GROUP;
  const int gbase = threadIdx.x & ~(K3_GROUP - 1);
  const int64_t lane = (int64_t)blockIdx.x * K3_LANES + ln;
  const bool live = lane < B;
  // a dead lane at the ragged end walks lane B - 1 again and stores nothing
  const int64_t b = live ? lane : B - 1;
  const uint32_t one[8] = CTPU_MONT_ONE;
  uint32_t kd[8], ident[8];  // d'; the identity (0, 1, 1) and its S = 1
  fr_ldg(kd, comb, K3_COMB_ELEMS + 1);
  fr_zero(ident);
  fr_select(ident, i == 0, ident, one);
  K3Fix fix;

  // the table of d * A': T[0] = identity, T[1] = A', T[d] = T[d - 1] + A'
  uint32_t v[8], q[8];
  {
    uint32_t x[8], y[8], root[8];
    fr_load(x, ax_m, b, B);
    fr_load(y, ay_m, b, B);
    fr_ldg(root, comb, K3_COMB_ELEMS);
    fr_mont_mul(x, x, root);
    k3_affine(q, x, y, i);
  }
  fr_copy(v, q);
  k3_tab_store(tab, 0, i, ln, ident);
  k3_tab_store(tab, 1, i, ln, v);
#pragma unroll 1
  for (int d = 2; d < 16; d++) {
    k3_add<false>(v, q, kd, fix, i, gbase);
    k3_sum_xy(v, i, gbase);
    k3_tab_store(tab, d, i, ln, v);
  }
  __syncwarp();

  fr_copy(v, ident);
  fr_zero(fix.x);
  fr_copy(fix.y, one);
  fr_copy(fix.z, one);
  uint32_t dh_next = nibble(hm, 63, b, B), ds_next = nibble(s, 63, b, B) & 1u;
#pragma unroll 1
  for (int jj = 63; jj >= 0; jj--) {
    const uint32_t dh = dh_next, ds = ds_next;
    if (jj > 0) {
      dh_next = nibble(hm, jj - 1, b, B);
      ds_next = nibble(s, jj - 1, b, B);
    }
    // the comb entry d_s * 16^jj * B8: elements px, py, kc
    const int e = (jj * 16 + (int)ds) * 3;
#pragma unroll 1
    for (int k = 0; k < 4; k++) {
      uint32_t u[8], a[8], bb[8], p1[8], cc[8], dd[8], hh[8], fa[8], fb[8];
      // thread 3's product of the fixed-base add, its operands fetched
      // before this doubling's first product
      if (k == 0) {  // C_f = FX px
        fr_copy(fa, fix.x);
        fr_ldg(fb, comb, e);
      } else if (k == 1) {  // D_f = FY py
        fr_copy(fa, fix.y);
        fr_ldg(fb, comb, e + 1);
      } else if (k == 2) {  // B_f = FZ FZ
        fr_copy(fa, fix.z);
        fr_copy(fb, fix.z);
      } else {  // W_f = FX FY; and what the add's slots will need
        fr_copy(fa, fix.x);
        fr_copy(fb, fix.y);
        fr_ldg(u, comb, e);
        fr_ldg(a, comb, e + 1);
        fr_add(fix.ps, u, a);
        fr_ldg(fix.kc, comb, e + 2);
      }
      // D1: M = X Y, D = Y Y, H = Z Z, C = X X
      fr_shfl(u, v, gbase + (i == 0 ? 1 : i == 3 ? 0 : i));
      fr_select(a, i == 3, u, v);
      fr_mont_mul(p1, a, u);
      k3_bcast(cc, p1, gbase, 3);
      k3_bcast(dd, p1, gbase, 1);
      k3_bcast(hh, p1, gbase, 2);
      // F = C + D in every thread; thread 1: G = C - D; threads 0 and 2:
      // J = F - 2 H; thread 0: 2 M
      fr_add(u, cc, dd);
      fr_add(hh, hh, hh);
      fr_select(a, i == 1, cc, u);
      fr_select(bb, i == 1, dd, hh);
      fr_sub(bb, a, bb);
      fr_add(a, p1, p1);
      // D2: X' = 2M J, Y' = F G, Z' = F J
      fr_select(a, i == 0, a, u);
      fr_select(a, i == 3, fa, a);
      fr_select(bb, i == 3, fb, bb);
      fr_mont_mul(v, a, bb);
      if (k == 0) {
        fr_copy(fix.c, v);
      } else if (k == 1) {
        fr_copy(fix.d, v);
      } else if (k == 2) {
        fr_copy(fix.b, v);
      } else {
        fr_copy(fix.w, v);
      }
    }
    k3_sum_xy(v, i, gbase);
    k3_tab_load(q, tab, (int)dh, i, ln);
    k3_add<true>(v, q, kd, fix, i, gbase);
  }

  // rhs = hm * A' + R8', then fix == rhs as projective points
  {
    uint32_t x[8], y[8], root[8];
    fr_load(x, r8x_m, b, B);
    fr_load(y, r8y_m, b, B);
    fr_ldg(root, comb, K3_COMB_ELEMS);
    fr_mont_mul(x, x, root);
    k3_affine(q, x, y, i);
  }
  k3_sum_xy(v, i, gbase);
  k3_add<false>(v, q, kd, fix, i, gbase);
  // thread 0 FX RZ, thread 1 RX FZ, thread 2 FY RZ, thread 3 RY FZ
  uint32_t rv[8], fv[8], l[8], lo[8];
  fr_shfl(rv, v, gbase + (i == 1 ? 0 : i == 3 ? 1 : 2));
  k3_bcast(fv, fix.z, gbase, 3);
  k3_bcast(l, fix.x, gbase, 3);
  fr_select(fv, i == 0, l, fv);
  k3_bcast(l, fix.y, gbase, 3);
  fr_select(fv, i == 2, l, fv);
  fr_mont_mul(l, rv, fv);
#pragma unroll
  for (int w = 0; w < 8; w++) lo[w] = __shfl_xor_sync(FULL_WARP, l[w], 1);
  const unsigned eq = __ballot_sync(FULL_WARP, fr_eq(l, lo));
  if (live && i == 0) ok[b] = ((eq >> gbase) & 0xfu) == 0xfu ? 1 : 0;
}

// `comb` is convert.eddsa_kernel_words() in device memory.
extern "C" int ctpu_eddsa_check(const int64_t* ax_m, const int64_t* ay_m,
                                const int64_t* s, const int64_t* r8x_m,
                                const int64_t* r8y_m, const int64_t* hm,
                                const uint32_t* comb, uint8_t* ok, int64_t B,
                                void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + K3_LANES - 1) / K3_LANES));
  eddsa_kernel<<<grid, K3_THREADS, 0, (cudaStream_t)stream>>>(
      ax_m, ay_m, s, r8x_m, r8y_m, hm, comb, ok, B);
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_eddsa_funcs(void** out) {
  const void* k[] = {(const void*)eddsa_kernel};
  return kernel_funcs(k, 1, out);
}
