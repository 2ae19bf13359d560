// BN254 Fr arithmetic for one lane, in registers: 8 little-endian 32-bit
// words, Montgomery form with R = 2^256 (the same values as the 16 x 16-bit
// limb form the tensors carry, read two limbs to a word).
//
// Hopper multiplies 32 x 32 -> 64 bits natively (mul.wide.u32 / mad.hi),
// so the Montgomery product is word-level CIOS: 8 outer steps of one
// multiply-accumulate row and one reduction row. Every function takes and
// returns canonical values (< p), so results equal the plain PyTorch
// versions word for word.
#pragma once
#include <stdint.h>

namespace ctpu {

__device__ __forceinline__ uint32_t p_word(int i) {
  switch (i) {
    case 0: return 0xf0000001u;
    case 1: return 0x43e1f593u;
    case 2: return 0x79b97091u;
    case 3: return 0x2833e848u;
    case 4: return 0x8181585du;
    case 5: return 0xb85045b6u;
    case 6: return 0xe131a029u;
    default: return 0x30644e72u;
  }
}

constexpr uint32_t FR_N0 = 0xefffffffu;  // -p^-1 mod 2^32

// Montgomery forms of 1 (R mod p) and R^2 mod p, and of the BabyJubJub
// curve constants a = 168700, d = 168696.
#define CTPU_MONT_ONE {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, \
                       0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
#define CTPU_R2 {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, \
                 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u}
#define CTPU_BJJ_A {0xfff261e0u, 0x95accf61u, 0x9df7d378u, 0x24780d65u, \
                    0x7e906ae8u, 0xe0ac11b0u, 0x16d3def3u, 0x0f35db22u}
#define CTPU_BJJ_D {0xaff261f5u, 0x2735f484u, 0x9a2e0f63u, 0x70ba1b57u, \
                    0x1e2caa8cu, 0xff41c9a9u, 0x8fe6025fu, 0x07704a8eu}

__device__ __forceinline__ void fr_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = a[k];
}

__device__ __forceinline__ void fr_zero(uint32_t r[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = 0u;
}

// r = t - p if t >= p else t, for t < 2^256 given with a ninth top word.
__device__ __forceinline__ void fr_reduce_once(uint32_t r[8], const uint32_t t[8],
                                               uint32_t top) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t s = (uint64_t)t[k] - p_word(k) - borrow;
    d[k] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  bool keep = (top == 0u) && borrow;  // t < p
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = keep ? t[k] : d[k];
}

__device__ __forceinline__ void fr_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)a[k] + b[k] + c;
    s[k] = (uint32_t)v;
    c = v >> 32;
  }
  fr_reduce_once(r, s, (uint32_t)c);
}

__device__ __forceinline__ void fr_sub(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)d[k] + (p_word(k) & mask) + c;
    r[k] = (uint32_t)v;
    c = v >> 32;
  }
}

// a * b * 2^-256 mod p (CIOS). Inputs canonical, output canonical.
__device__ __forceinline__ void fr_mont_mul(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FR_N0;
    s = (uint64_t)m * p_word(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * p_word(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  fr_reduce_once(r, t, t[8]);
}

__device__ __forceinline__ bool fr_eq(const uint32_t a[8], const uint32_t b[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) acc |= a[k] ^ b[k];
  return acc == 0u;
}

__device__ __forceinline__ void fr_select(uint32_t r[8], bool c, const uint32_t a[8],
                                          const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = c ? a[k] : b[k];
}

// Lane `b` of a (16, B) int64 limb tensor -> 8 words, and back.
__device__ __forceinline__ void fr_load(uint32_t r[8], const int64_t* __restrict__ x,
                                        int64_t b, int64_t B) {
#pragma unroll
  for (int k = 0; k < 8; k++)
    r[k] = (uint32_t)x[(2 * k) * B + b] | ((uint32_t)x[(2 * k + 1) * B + b] << 16);
}

__device__ __forceinline__ void fr_store(int64_t* __restrict__ x, const uint32_t a[8],
                                         int64_t b, int64_t B) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[(2 * k) * B + b] = (int64_t)(a[k] & 0xffffu);
    x[(2 * k + 1) * B + b] = (int64_t)(a[k] >> 16);
  }
}

}  // namespace ctpu
