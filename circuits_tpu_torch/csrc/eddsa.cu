// K3: the EdDSA-Poseidon group check S * B8 == R8 + hm * A on BabyJubJub,
// batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_eddsa.py
// (`_compiled` -> pallas_call of `_kernel`, entry `eddsa_ok_mont`), with
// the same algorithm and the same formulas: projective twisted-Edwards
// coordinates in Montgomery form (a = 168700, d = 168696), unified add
// add-2008-bbjlp (13 products), mixed add with an affine point (12) and
// doubling dbl-2008-bbjlp (8).
//  * fixed base S * B8: 4-bit comb over the 64 x 16 affine table of
//    d * 16^j * B8, one mixed add per window;
//  * variable base hm * A: a 16-entry table of d * A built in the thread,
//    then 64 x (4 doublings + 1 add), most significant window first;
//  * the final check is projective (X1 Z2 == X2 Z1, Y1 Z2 == Y2 Z1).
// S is read as 253 bits (circomlib's Num2Bits(253) on S, and the XLA path
// of the JAX package): the top window of S keeps only bit 252.
//
// What bounds it on the card: ~3.8k Montgomery products per lane, integer
// multiply issue. The 16-point table (16 * 3 * 32 B = 1.5 KiB a thread) is
// indexed by a data-dependent digit and so lives in local memory; the
// 64 KiB comb table stays in global memory, cached by L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace ctpu;

struct Pt {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void mul_a(uint32_t r[8], const uint32_t c[8]) {
  const uint32_t a[8] = CTPU_BJJ_A;
  fr_mont_mul(r, c, a);
}

__device__ __forceinline__ void mul_d(uint32_t r[8], const uint32_t c[8]) {
  const uint32_t d[8] = CTPU_BJJ_D;
  fr_mont_mul(r, c, d);
}

// unified add (add-2008-bbjlp); `az` is z1 * z2 (z1 for a mixed add)
__device__ __forceinline__ void padd_core(Pt& o, const Pt& p, const uint32_t x2[8],
                                          const uint32_t y2[8], const uint32_t az[8]) {
  uint32_t bb[8], c[8], d[8], e[8], f[8], g[8], t[8], u[8], v[8], s1[8], s2[8];
  fr_mont_mul(bb, az, az);
  fr_mont_mul(c, p.x, x2);
  fr_mont_mul(d, p.y, y2);
  fr_mont_mul(t, c, d);
  mul_d(e, t);
  fr_sub(f, bb, e);
  fr_add(g, bb, e);
  fr_add(s1, p.x, p.y);
  fr_add(s2, x2, y2);
  fr_mont_mul(t, s1, s2);
  fr_sub(u, t, c);
  fr_sub(u, u, d);
  mul_a(s1, c);
  fr_sub(v, d, s1);
  fr_mont_mul(s1, az, f);
  fr_mont_mul(o.x, s1, u);
  fr_mont_mul(s2, az, g);
  fr_mont_mul(o.y, s2, v);
  fr_mont_mul(o.z, f, g);
}

__device__ __forceinline__ void padd(Pt& o, const Pt& p, const Pt& q) {
  uint32_t a[8];
  fr_mont_mul(a, p.z, q.z);
  Pt r;
  padd_core(r, p, q.x, q.y, a);
  o = r;
}

__device__ __forceinline__ void padd_affine(Pt& o, const Pt& p, const uint32_t x2[8],
                                            const uint32_t y2[8]) {
  Pt r;
  padd_core(r, p, x2, y2, p.z);
  o = r;
}

__device__ __forceinline__ void pdouble(Pt& p) {
  uint32_t xy[8], b[8], c[8], d[8], h[8], e[8], f[8], j[8], t[8];
  fr_add(xy, p.x, p.y);
  fr_mont_mul(b, xy, xy);
  fr_mont_mul(c, p.x, p.x);
  fr_mont_mul(d, p.y, p.y);
  fr_mont_mul(h, p.z, p.z);
  mul_a(e, c);
  fr_add(f, e, d);
  fr_sub(j, f, h);
  fr_sub(j, j, h);
  fr_sub(t, b, c);
  fr_sub(t, t, d);
  fr_mont_mul(p.x, t, j);
  fr_sub(t, e, d);
  fr_mont_mul(p.y, f, t);
  fr_mont_mul(p.z, f, j);
}

__device__ __forceinline__ uint32_t nibble(const int64_t* __restrict__ x, int jj,
                                           int64_t b, int64_t B) {
  return ((uint32_t)x[(int64_t)(jj >> 2) * B + b] >> ((jj & 3) * 4)) & 15u;
}

__global__ void __launch_bounds__(64)
eddsa_kernel(const int64_t* __restrict__ ax_m, const int64_t* __restrict__ ay_m,
             const int64_t* __restrict__ s, const int64_t* __restrict__ r8x_m,
             const int64_t* __restrict__ r8y_m, const int64_t* __restrict__ hm,
             const uint32_t* __restrict__ comb, uint8_t* __restrict__ ok, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t one[8] = CTPU_MONT_ONE;
  uint32_t ax[8], ay[8];
  fr_load(ax, ax_m, b, B);
  fr_load(ay, ay_m, b, B);

  Pt tab[16];  // d * A, projective
  fr_zero(tab[0].x);
  fr_copy(tab[0].y, one);
  fr_copy(tab[0].z, one);
  fr_copy(tab[1].x, ax);
  fr_copy(tab[1].y, ay);
  fr_copy(tab[1].z, one);
#pragma unroll 1
  for (int d = 2; d < 16; d++) padd_affine(tab[d], tab[d - 1], ax, ay);

  Pt var = tab[0], fix = tab[0];
#pragma unroll 1
  for (int k = 0; k < 64; k++) {
    const int jj = 63 - k;
#pragma unroll 1
    for (int i = 0; i < 4; i++) pdouble(var);
    padd(var, var, tab[nibble(hm, jj, b, B)]);
    uint32_t ds = nibble(s, jj, b, B);
    if (jj == 63) ds &= 1u;  // S is 253 bits wide
    const uint32_t* e = comb + ((int64_t)jj * 16 + ds) * 16;  // (x, y) words
    uint32_t px[8], py[8];
#pragma unroll
    for (int w = 0; w < 8; w++) {
      px[w] = __ldg(e + w);
      py[w] = __ldg(e + 8 + w);
    }
    padd_affine(fix, fix, px, py);
  }
  uint32_t r8x[8], r8y[8];
  fr_load(r8x, r8x_m, b, B);
  fr_load(r8y, r8y_m, b, B);
  Pt rhs;
  padd_affine(rhs, var, r8x, r8y);
  uint32_t l1[8], l2[8], l3[8], l4[8];
  fr_mont_mul(l1, fix.x, rhs.z);
  fr_mont_mul(l2, rhs.x, fix.z);
  fr_mont_mul(l3, fix.y, rhs.z);
  fr_mont_mul(l4, rhs.y, fix.z);
  ok[b] = (fr_eq(l1, l2) && fr_eq(l3, l4)) ? 1 : 0;
}

extern "C" int ctpu_eddsa_check(const int64_t* ax_m, const int64_t* ay_m,
                                const int64_t* s, const int64_t* r8x_m,
                                const int64_t* r8y_m, const int64_t* hm,
                                const uint32_t* comb, uint8_t* ok, int64_t B,
                                void* stream) {
  const int threads = 64;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  eddsa_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      ax_m, ay_m, s, r8x_m, r8y_m, hm, comb, ok, B);
  return (int)cudaGetLastError();
}
