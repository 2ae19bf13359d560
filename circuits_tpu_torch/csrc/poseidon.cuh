// The circomlib Poseidon permutation over BN254 Fr, one state element per
// thread: the t elements of a lane's state sit in t consecutive threads of
// a G-thread group (G = 4 or 8, a power of two, inside one warp), 8
// Montgomery words each, and travel between those threads by warp shuffles.
// No shared memory and no block barrier.
//
// Sparse schedule (poseidon_constants.optimized_constants; the JAX
// package's permute_opt_body): 3 full rounds with the MDS matrix m; one
// full round with pre_sparse, then + d; R_P partial rounds
//     x0 = s[0]^5 + e[r]
//     new0 = sparse_row[r][0] * x0 + sum_{j>=1} sparse_row[r][j] * s[j]
//     s[j] += sparse_col[r][j-1] * x0            (j >= 1)
// and 4 full rounds with m. A partial round costs 2t + 2 Montgomery
// products instead of the dense schedule's t^2 + 3. What sets the time of
// a small batch is the chain of dependent products, and a partial round's
// is short whatever t is: the t - 1 products sparse_row[r][j] * s[j] run in
// threads 1..t-1 in the same instruction as thread 0's first squaring,
// which leaves 4 dependent products a round; where the group has a spare
// thread (t < G) that thread forms sparse_row[r][0] * s[0] meanwhile and
// the chain is 3 (poseidon_partial_rounds_helped). All values stay
// canonical (< p), so the output equals the plain versions word for word.
//
// The constants (3,783 elements, 121,056 B for t = 3..7) do not fit the
// 64 KiB __constant__ bank; they live in device memory and are read
// through the read-only path (__ldg, 16 bytes a load). The threads of a
// group read neighbouring elements of one round's row.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace ctpu {

constexpr int POSEIDON_RF = 8;
constexpr unsigned FULL_WARP = 0xffffffffu;

__host__ __device__ constexpr int poseidon_rp(int t) {
  // circomlib's partial-round table (poseidon_constants.N_ROUNDS_P)
  return t == 3 ? 57 : t == 4 ? 56 : t == 5 ? 60 : t == 6 ? 60 : 63;
}

// Elements of width t's block of the constant table: full_c (8 t), d (t),
// e (rp), m (t t), pre_sparse (t t), sparse_row (rp t), sparse_col
// (rp (t - 1)), row0_e (rp; sparse_row[r][0] * e[r]), in this order
// (convert.poseidon_kernel_words).
__host__ __device__ constexpr int sparse_block(int t) {
  return POSEIDON_RF * t + t + poseidon_rp(t) + 2 * t * t +
         poseidon_rp(t) * t + poseidon_rp(t) * (t - 1) + poseidon_rp(t);
}

// Element offset of width t's block: widths 3..7 in turn.
__host__ __device__ constexpr int sparse_offset(int t) {
  return t <= 3 ? 0 : sparse_offset(t - 1) + sparse_block(t - 1);
}

constexpr int SPARSE_ELEMS = sparse_offset(8);
static_assert(SPARSE_ELEMS == 3783, "layout differs from convert.py");

// Element `idx` (8 words, 32-byte aligned) of a constant table.
__device__ __forceinline__ void fr_ldg(uint32_t r[8], const uint32_t* __restrict__ tab,
                                       int idx) {
  const uint4* p = reinterpret_cast<const uint4*>(tab) + 2 * idx;
  const uint4 lo = __ldg(p), hi = __ldg(p + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// a[] of warp thread `src`, in every thread.
__device__ __forceinline__ void fr_shfl(uint32_t r[8], const uint32_t a[8], int src) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = __shfl_sync(FULL_WARP, a[k], src);
}

// x += the x of the thread whose index differs in bit `m`.
__device__ __forceinline__ void fr_add_xor(uint32_t x[8], int m) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = __shfl_xor_sync(FULL_WARP, x[k], m);
  fr_add(x, x, w);
}

// One full round: s += c[i]; s = s^5; s = sum_j mat[i][j] * s_j.
__device__ __forceinline__ void poseidon_full_round(
    uint32_t s[8], const uint32_t* __restrict__ c, const uint32_t* __restrict__ mat,
    int t, int ic, int gbase) {
  uint32_t k[8], acc[8];
  fr_ldg(k, c, ic);
  fr_add(s, s, k);
  fr_pow5(s);
  fr_zero(acc);
#pragma unroll 1
  for (int j = 0; j < t; j++) {
    uint32_t v[8], p[8];
    fr_shfl(v, s, gbase + j);
    fr_ldg(k, mat, ic * t + j);
    fr_mont_mul(p, k, v);
    fr_add(acc, acc, p);
  }
  fr_copy(s, acc);
}

// The partial rounds of a group with no spare thread (t == G): thread i
// holds element i. A round is the chain s0^2, s0^4, x0 = s0^5 + e,
// sparse_row[r][0] * x0: 4 dependent products. The sum of the other threads'
// sparse_row[r][j] * s_j does not wait for x0 and is folded first.
template <int G>
__device__ __forceinline__ void poseidon_partial_rounds_serial(
    uint32_t s[8], const uint32_t* __restrict__ e,
    const uint32_t* __restrict__ sparse_row, const uint32_t* __restrict__ sparse_col,
    int rp, int i, int gbase) {
  constexpr int t = G;
  const bool head = i == 0;
  // the last product's constant: sparse_row[r][0] or sparse_col[r][i-1]
  const uint32_t* second = head ? sparse_row : sparse_col + 8 * (i - 1);
  const int second_t = head ? t : t - 1;
  // A warp reads each round's constants once a permutation, so most of
  // these loads miss L1: round r + 1's three elements are fetched while
  // round r's products run, not where they are used.
  uint32_t ka[8], ke[8], kb[8];
  fr_ldg(ka, sparse_row, i);
  fr_ldg(ke, e, 0);
  fr_ldg(kb, second, 0);
#pragma unroll 1
  for (int r = 0; r < rp; r++) {
    uint32_t na[8], ne[8], nb[8], y[8], x[8], q[8], sum[8];
    const int rn = r + 1 < rp ? r + 1 : r;
    fr_ldg(na, sparse_row, rn * t + i);
    fr_ldg(ne, e, rn);
    fr_ldg(nb, second, rn * second_t);
    // thread 0: y = s0^2; thread j >= 1: y = sparse_row[r][j] * s_j
    fr_select(ka, head, s, ka);
    fr_mont_mul(y, ka, s);
    // sum = sum_{j >= 1} sparse_row[r][j] * s_j, in every thread
    fr_zero(sum);
    fr_select(sum, head, sum, y);
#pragma unroll
    for (int mbit = 1; mbit < G; mbit <<= 1) fr_add_xor(sum, mbit);
    // thread 0: x = s0^5 + e[r] (the other threads' x is not used)
    fr_mont_mul(x, y, y);
    fr_mont_mul(x, x, s);
    fr_add(x, x, ke);
    fr_shfl(x, x, gbase);
    // thread 0: q = sparse_row[r][0] * x0; thread j: sparse_col[r][j-1] * x0
    fr_mont_mul(q, kb, x);
    // thread 0: the new s0 = q + sum; thread j: the new s_j = q + s_j
    fr_select(sum, head, sum, s);
    fr_add(s, q, sum);
    fr_copy(ka, na);
    fr_copy(ke, ne);
    fr_copy(kb, nb);
  }
}

// The partial rounds of a group with a spare thread (t < G), which
// shortens a round's chain to 3 dependent products. Thread 0 (the head)
// walks s0^2, s0^4 and s0^4 * u, where u = sparse_row[r][0] * s0 was formed
// beside its first squaring by thread t (the helper), so
//     new s0 = sparse_row[r][0] * s0^5 + (row0_e[r] + sum_j sparse_row[r][j] * s_j)
// with row0_e[r] = sparse_row[r][0] * e[r] from the table, and the bracket
// is ready before the third product ends. The helper also forms
// x0 = s0^4 * s0 + e[r] beside the third product, and threads 1..t-1 take it
// one round late: round r + 1 opens with s_j += sparse_col[r][j-1] * x0 in
// the instruction of the head's squaring, and the last round's update
// follows the loop. Every shuffle is off the head's chain.
template <int G>
__device__ __forceinline__ void poseidon_partial_rounds_helped(
    uint32_t s[8], const uint32_t* __restrict__ e,
    const uint32_t* __restrict__ sparse_row, const uint32_t* __restrict__ sparse_col,
    const uint32_t* __restrict__ row0_e, int t, int rp, int i, int gbase) {
  const bool head = i == 0, helper = i == t;
  const int iw = i < t ? i : t - 1;  // helper and passengers read legal constants
  // k1 multiplies in the first product: the helper's sparse_row[r][0], a
  // worker's sparse_col[r-1][j-1]. k2: a worker's sparse_row[r][j] for the
  // second product, the helper's e[r], the head's row0_e[r].
  const bool k1_row = head || helper;
  const uint32_t* k1_tab = k1_row ? sparse_row : sparse_col + 8 * (iw - 1);
  const int k1_t = k1_row ? t : t - 1;
  const uint32_t* k2_tab = head ? row0_e : helper ? e : sparse_row + 8 * iw;
  const int k2_t = head || helper ? 1 : t;
  uint32_t k1[8], k2[8], x0[8], s0[8];
  fr_ldg(k1, k1_tab, 0);
  fr_ldg(k2, k2_tab, 0);
  fr_zero(x0);  // no update is pending before the first round
  fr_shfl(s0, s, gbase);
#pragma unroll 1
  for (int r = 0; r < rp; r++) {
    uint32_t n1[8], n2[8], a[8], b[8], c[8], u[8], v[8], sum[8];
    // the next round's constants, fetched a round ahead (they miss L1); the
    // worker's k1 of round rp is the update that follows the loop
    const int rn = r + 1 < rp ? r + 1 : r;
    fr_ldg(n1, k1_tab, (k1_row ? rn : r) * k1_t);
    fr_ldg(n2, k2_tab, rn * k2_t);
    // first product. head: a = s0^2; helper: a = u; worker: the pending
    // update s_j += sparse_col[r-1][j-1] * x0
    fr_select(u, head, s, k1);
    fr_select(v, helper, s0, x0);
    fr_select(v, head, s, v);
    fr_mont_mul(a, u, v);
    fr_add(v, s, a);
    fr_select(s, head, s, v);
    // second product. head: b = s0^4; worker: b = sparse_row[r][j] * s_j
    fr_select(u, head, a, k2);
    fr_select(v, head, a, s);
    fr_mont_mul(b, u, v);
    // sum = row0_e[r] + sum_j sparse_row[r][j] * s_j, in every thread
    fr_zero(sum);
    fr_select(sum, i < t, b, sum);
    fr_select(sum, head, k2, sum);
#pragma unroll
    for (int mbit = 1; mbit < G; mbit <<= 1) fr_add_xor(sum, mbit);
    // third product. head: c = s0^4 * u; the others: c = s0^4 * s0
    fr_shfl(u, a, gbase + t);
    fr_shfl(v, b, gbase);
    fr_select(u, head, u, s0);
    fr_select(v, head, b, v);
    fr_mont_mul(c, u, v);
    // head: the new s0 = c + sum; helper: x0 = s0^5 + e[r]
    fr_select(sum, head, sum, k2);
    fr_add(c, c, sum);
    fr_select(s, head, c, s);
    fr_shfl(x0, c, gbase + t);
    fr_shfl(s0, c, gbase);
    fr_copy(k1, n1);
    fr_copy(k2, n2);
  }
  // the last round's update of s_1..s_{t-1}
  uint32_t a[8];
  fr_mont_mul(a, k1, x0);
  fr_add(a, s, a);
  fr_select(s, head, s, a);
}

// The permutation of one lane's state by the G threads of its group.
// Every thread of the warp must call it (the shuffles name the full warp).
// `i` is the thread's index in its group; thread i < t holds element i in
// s[] (Montgomery, canonical) and gets the permuted element back; a thread
// with i >= t is a passenger whose s[] is ignored and comes back
// undefined. `tab` is width t's block of the constant table.
template <int G>
__device__ __forceinline__ void poseidon_permute_group(
    uint32_t s[8], const uint32_t* __restrict__ tab, int t, int i) {
  static_assert(G == 4 || G == 8, "a group is 4 or 8 threads of one warp");
  const int rp = poseidon_rp(t);
  const uint32_t* full_c = tab;
  const uint32_t* d = full_c + 8 * (POSEIDON_RF * t);
  const uint32_t* e = d + 8 * t;
  const uint32_t* m = e + 8 * rp;
  const uint32_t* pre_sparse = m + 8 * (t * t);
  const uint32_t* sparse_row = pre_sparse + 8 * (t * t);
  const uint32_t* sparse_col = sparse_row + 8 * (rp * t);
  const uint32_t* row0_e = sparse_col + 8 * (rp * (t - 1));
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const int ic = i < t ? i : t - 1;  // a passenger reads legal constants

#pragma unroll 1
  for (int r = 0; r < POSEIDON_RF / 2; r++)
    poseidon_full_round(s, full_c + 8 * (r * t),
                        r < POSEIDON_RF / 2 - 1 ? m : pre_sparse, t, ic, gbase);
  {
    uint32_t k[8];
    fr_ldg(k, d, ic);
    fr_add(s, s, k);
  }
  if (t < G)
    poseidon_partial_rounds_helped<G>(s, e, sparse_row, sparse_col, row0_e, t, rp,
                                      i, gbase);
  else if constexpr (G == 4)  // t == G: width 4 alone fills its group
    poseidon_partial_rounds_serial<G>(s, e, sparse_row, sparse_col, rp, i, gbase);
#pragma unroll 1
  for (int r = POSEIDON_RF / 2; r < POSEIDON_RF; r++)
    poseidon_full_round(s, full_c + 8 * (r * t), m, t, ic, gbase);
}

}  // namespace ctpu
