// AySign2Ax: x of a BabyJubJub point from its y and the sign bit (circomlib
// Bits2Point_Strict, the public key of a signature), batched over lanes.
//
// Replaces no TPU kernel: the JAX package computes this step in plain JAX,
// which XLA fuses. The port's plain version (`ay_sign_to_ax_plain` in
// ops/babyjubjub.py) is some 200,000 small PyTorch operations, nearly all of
// the captured rollup graph's nodes; this kernel is one node.
//
// The plain version's steps, a lane in one thread, on 8 x 32-bit Montgomery
// words in registers (field.cuh):
//   y to Montgomery form, y^2, num = 1 - y^2, den = A - D y^2;
//   den_zero flagged and 1 put in its place; inv = den^(p - 2);
//   x^2 = num inv;
//   fr.sqrt's constant-structure Tonelli-Shanks: z = (x^2 == 0) and 1 put in
//   its place (a); t = a^Q, r = a^((Q + 1) / 2), c the 2^28-th root of unity
//   g^Q; for i = 28 .. 2: b = t^(2^(i - 2)); where b != 1, r = r c; c = c^2;
//   where b != 1, t = t c;
//   found = (r^2 == a) and not z; root = r canonical, 0 where z or not found;
//   root = min(root, p - root) as integers; ax = p - root where sign is set;
//   ok = (found or z) and not den_zero.
// Two fixed powers take shorter chains than the plain version's, with the
// same values: w = a^((Q - 1) / 2), then r = w a and t = w r, in place of the
// two powers a^Q and a^((Q + 1) / 2); and r^2 == a in Montgomery form in place
// of root^2 == x^2 canonical (the same equality). Skipping from_mont then
// to_mont of x^2 leaves it as it was, since both are exact on canonical
// values.
//
// What bounds it on the card: one lane's chain of dependent products, 892 of
// the 1,398 it forms (the inverse's 254 squarings, the sqrt's power's 225,
// Tonelli-Shanks' 351 squarings and 54 products), since the main path's
// 2,048 lanes are 64 warps, one on an SM's scheduler at most. So a power
// walks its exponent from the least significant bit and forms both products
// of a step, base^2 and acc * base, and keeps the second where the bit is
// set: the two are independent, so the multiply hides behind the squaring
// and the chain is the squarings alone. The exponents are constants and
// Tonelli-Shanks' choices are selects, so the warp never diverges.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "funcs.cuh"

using namespace ctpu;

constexpr int AS_THREADS = 32;  // one warp a block: 2,048 lanes on 64 SMs
constexpr int AS_TWO_ADICITY = 28;  // p - 1 = Q 2^28, Q odd

// exponents, little-endian words: p - 2, and (Q - 1) / 2 (225 bits)
__constant__ uint32_t AS_EXP_INV[8] = {
    0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr int AS_EXP_INV_BITS = 254;
__constant__ uint32_t AS_EXP_HALF[8] = {
    0x1f0fac9fu, 0xcdcb848au, 0x419f4243u, 0x0c0ac2e9u,
    0xc2822db4u, 0x098d014du, 0x83227397u, 0x00000001u};
constexpr int AS_EXP_HALF_BITS = 225;
// Montgomery forms of the curve's A = 168700 and D = 168696, and of the
// 2^28-th root of unity g^Q (g = 5, the least non-residue)
__constant__ uint32_t AS_A_M[8] = {
    0xfff261e0u, 0x95accf61u, 0x9df7d378u, 0x24780d65u,
    0x7e906ae8u, 0xe0ac11b0u, 0x16d3def3u, 0x0f35db22u};
__constant__ uint32_t AS_D_M[8] = {
    0xaff261f5u, 0x2735f484u, 0x9a2e0f63u, 0x70ba1b57u,
    0x1e2caa8cu, 0xff41c9a9u, 0x8fe6025fu, 0x07704a8eu};
__constant__ uint32_t AS_ROOT_M[8] = {
    0x80d13d9cu, 0x636e7355u, 0x2445ffd6u, 0xa22bf374u,
    0x1eb203d8u, 0x56452ac0u, 0x2963f9e7u, 0x1860ef94u};

__device__ __forceinline__ void as_const(uint32_t r[8], const uint32_t* c) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = c[k];
}

// r = a^e for the fixed exponent e (`nbits` bits, words little-endian),
// Montgomery in and out; least significant bit first, both products a step.
// acc starts at 1, and 1 * a is a exactly, as the plain version's first
// factor.
__device__ __forceinline__ void as_pow(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t* e, int nbits) {
  uint32_t base[8], acc[8] = CTPU_MONT_ONE, prod[8];
  fr_copy(base, a);
#pragma unroll 1
  for (int i = 0; i < nbits; i++) {
    fr_mont_mul(prod, acc, base);
    fr_mont_mul(base, base, base);
    fr_select(acc, (e[i >> 5] >> (i & 31)) & 1u, prod, acc);
  }
  fr_copy(r, acc);
}

// a > b as integers (canonical), decided at the most significant word that
// differs.
__device__ __forceinline__ bool as_gt(const uint32_t a[8], const uint32_t b[8]) {
  bool gt = false;
#pragma unroll
  for (int k = 0; k < 8; k++) gt = a[k] != b[k] ? a[k] > b[k] : gt;
  return gt;
}

// ay: canonical (16, B) int64 limbs; sign: B bytes, 0 or 1 (torch.bool);
// ax: (16, B) canonical; ok: B bytes, 0 or 1.
__global__ void __launch_bounds__(AS_THREADS)
ay_sign_to_ax_kernel(const int64_t* __restrict__ ay, const uint8_t* __restrict__ sign,
                     int64_t* __restrict__ ax, uint8_t* __restrict__ ok, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * AS_THREADS + threadIdx.x;
  if (b >= B) return;
  const uint32_t one[8] = CTPU_MONT_ONE, r2[8] = CTPU_R2;
  uint32_t zero[8], k[8], u[8], num[8], den[8];
  fr_zero(zero);

  // num = 1 - y^2, den = A - D y^2
  fr_load(u, ay, b, B);
  fr_mont_mul(u, u, r2);
  fr_mont_mul(u, u, u);
  fr_sub(num, one, u);
  as_const(k, AS_D_M);
  fr_mont_mul(u, k, u);
  as_const(k, AS_A_M);
  fr_sub(den, k, u);
  const bool den_zero = fr_eq(den, zero);
  fr_select(den, den_zero, one, den);

  // a = x^2 = num / den, 1 where it is 0
  uint32_t a[8];
  as_pow(u, den, AS_EXP_INV, AS_EXP_INV_BITS);
  fr_mont_mul(a, num, u);
  const bool z = fr_eq(a, zero);
  fr_select(a, z, one, a);

  // Tonelli-Shanks
  uint32_t r[8], t[8], c[8], bb[8];
  as_pow(u, a, AS_EXP_HALF, AS_EXP_HALF_BITS);
  fr_mont_mul(r, u, a);  // a^((Q + 1) / 2)
  fr_mont_mul(t, u, r);  // a^Q
  as_const(c, AS_ROOT_M);
#pragma unroll 1
  for (int i = AS_TWO_ADICITY; i > 1; i--) {
    // r c and c^2 do not wait for b
    fr_mont_mul(u, r, c);
    fr_mont_mul(c, c, c);
    fr_copy(bb, t);
#pragma unroll 1
    for (int j = 0; j < i - 2; j++) fr_mont_mul(bb, bb, bb);
    const bool b_is_one = fr_eq(bb, one);
    fr_select(r, b_is_one, r, u);
    fr_mont_mul(u, t, c);
    fr_select(t, b_is_one, t, u);
  }
  fr_mont_mul(u, r, r);
  const bool found = fr_eq(u, a) && !z;

  // the minimal root, canonical, 0 where there is none; negated by the sign
  uint32_t canon_one[8];
  fr_zero(canon_one);
  canon_one[0] = 1u;
  fr_mont_mul(r, r, canon_one);
  fr_select(r, z || !found, zero, r);
  fr_sub(u, zero, r);
  fr_select(r, as_gt(r, u), u, r);
  fr_sub(u, zero, r);
  fr_select(r, sign[b] != 0, u, r);
  fr_store(ax, r, b, B);
  ok[b] = (found || z) && !den_zero;
}

extern "C" int ctpu_ay_sign_to_ax(const int64_t* ay, const uint8_t* sign, int64_t* ax,
                                  uint8_t* ok, int64_t B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + AS_THREADS - 1) / AS_THREADS));
  ay_sign_to_ax_kernel<<<grid, AS_THREADS, 0, (cudaStream_t)stream>>>(ay, sign, ax, ok,
                                                                      B);
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_ay_sign_funcs(void** out) {
  const void* k[] = {(const void*)ay_sign_to_ax_kernel};
  return kernel_funcs(k, 1, out);
}
