// BN254 Fr arithmetic for one lane, in registers: 8 little-endian 32-bit
// words, Montgomery form with R = 2^256 (the same values as the 16 x 16-bit
// limb form the tensors carry, read two limbs to a word).
//
// Hopper multiplies 32 x 32 -> 64 bits natively, so the Montgomery product
// works on words: 8 rows, each one multiply-accumulate of a by a word of b
// and one of p by the row's quotient word, written as PTX carry chains on
// aligned word pairs (`fr_mont_row`). Every function takes and returns
// canonical values (< p), so results equal the plain PyTorch versions word
// for word.
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

// Montgomery forms of 1 (R mod p) and R^2 mod p.
#define CTPU_MONT_ONE {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, \
                       0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
#define CTPU_R2 {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, \
                 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u}

__device__ __forceinline__ void fr_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = a[k];
}

__device__ __forceinline__ void fr_zero(uint32_t r[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = 0u;
}

// r = t - p if t >= p else t, for t < 2^256 given with a ninth top word.
// The subtraction is one PTX borrow chain.
__device__ __forceinline__ void fr_reduce_once(uint32_t r[8], const uint32_t t[8],
                                               uint32_t top) {
  uint32_t d[8], borrow;  // borrow: all ones if t < p
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(p_word(0)), "r"(p_word(1)), "r"(p_word(2)),
        "r"(p_word(3)), "r"(p_word(4)), "r"(p_word(5)), "r"(p_word(6)),
        "r"(p_word(7)));
  const bool keep = (top == 0u) && (borrow != 0u);  // t < p
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = keep ? t[k] : d[k];
}

// (a + b) mod p; one PTX carry chain, then the conditional subtraction.
__device__ __forceinline__ void fr_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t s[8], c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(s[0]), "=&r"(s[1]), "=&r"(s[2]), "=&r"(s[3]), "=&r"(s[4]),
        "=&r"(s[5]), "=&r"(s[6]), "=&r"(s[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  fr_reduce_once(r, s, c);
}

// (a - b) mod p; a borrow chain, then p added back where it borrowed.
__device__ __forceinline__ void fr_sub(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t d[8], mask;  // mask: all ones if a < b
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]), "=&r"(r[4]),
        "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
        "r"(d[6]), "r"(d[7]), "r"(p_word(0) & mask), "r"(p_word(1) & mask),
        "r"(p_word(2) & mask), "r"(p_word(3) & mask), "r"(p_word(4) & mask),
        "r"(p_word(5) & mask), "r"(p_word(6) & mask), "r"(p_word(7) & mask));
}

// x[0..7] += c0 * m + c2 * m * 2^64 + c4 * m * 2^128 + c6 * m * 2^192, the
// carry out added to `top`: four 32 x 32 -> 64 products on aligned word
// pairs, one carry chain.
__device__ __forceinline__ void fr_mad_pairs(uint32_t x[8], uint32_t& top, uint32_t c0,
                                             uint32_t c2, uint32_t c4, uint32_t c6,
                                             uint32_t m) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
        "+r"(x[6]), "+r"(x[7]), "+r"(top)
      : "r"(c0), "r"(c2), "r"(c4), "r"(c6), "r"(m));
}

// One row of the Montgomery product. The running sum T is held in two word
// arrays so that every 64-bit product lands on an aligned pair of one of
// them: on entry `even[k]` is word k of T and `odd[k]` word k - 1
// (odd[0] == 0); the row forms (T + a * bi + m * p) / 2^32 with
// m = -T / p mod 2^32, and on exit `odd[k]` is word k of it and `even[k]`
// word k - 1 (even[0] == 0): the caller swaps the two for the next row.
__device__ __forceinline__ void fr_mont_row(uint32_t even[8], uint32_t odd[8],
                                            const uint32_t a[8], uint32_t bi) {
  // word 0 of `odd`'s old content joins even[0]; the rest moves down two
  // words and takes the products of a's odd words (words 1..8 of the sum)
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;"
      : "+r"(even[0]), "+r"(odd[0]), "+r"(odd[1]), "+r"(odd[2]), "+r"(odd[3]),
        "+r"(odd[4]), "+r"(odd[5]), "+r"(odd[6]), "+r"(odd[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(bi));
  // the products of a's even words (words 0..7; the carry is word 8)
  fr_mad_pairs(even, odd[7], a[0], a[2], a[4], a[6], bi);
  const uint32_t m = even[0] * FR_N0;
  uint32_t none = 0u;  // the sum stays below 2^288: no carry out of word 8
  fr_mad_pairs(odd, none, p_word(1), p_word(3), p_word(5), p_word(7), m);
  fr_mad_pairs(even, odd[7], p_word(0), p_word(2), p_word(4), p_word(6), m);
}

// a * b * 2^-256 mod p. Inputs canonical, output canonical. Eight rows of
// `fr_mont_row`, whose multiply-adds are PTX carry chains (mad.lo.cc /
// madc.hi.cc on aligned pairs, which the assembler can emit as one wide
// multiply-add each); r may be a or b.
__device__ __forceinline__ void fr_mont_mul(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t even[8], odd[8];
  fr_zero(even);
  fr_zero(odd);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    fr_mont_row(even, odd, a, b[i]);
    fr_mont_row(odd, even, a, b[i + 1]);
  }
  // word k of the result is even[k] + odd[k + 1]; it is below 2 p < 2^255
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(even[0]), "+r"(even[1]), "+r"(even[2]), "+r"(even[3]), "+r"(even[4]),
        "+r"(even[5]), "+r"(even[6]), "+r"(even[7])
      : "r"(odd[1]), "r"(odd[2]), "r"(odd[3]), "r"(odd[4]), "r"(odd[5]),
        "r"(odd[6]), "r"(odd[7]));
  fr_reduce_once(r, even, 0u);
}

// x = x^5 (the Poseidon S-box), Montgomery in and out.
__device__ __forceinline__ void fr_pow5(uint32_t x[8]) {
  uint32_t x2[8], x4[8];
  fr_mont_mul(x2, x, x);
  fr_mont_mul(x4, x2, x2);
  fr_mont_mul(x, x4, x);
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
