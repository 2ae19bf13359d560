// The circomlib Poseidon permutation over BN254 Fr for one lane, state in
// registers, round constants and MDS matrices in __constant__ memory.
//
// Dense schedule: every round adds its t constants, applies x^5 to the
// whole state (full rounds) or to state[0] (partial rounds), then mixes
// new[i] = sum_j M[i][j] * state[j]. All values stay in Montgomery form
// and canonical, so the output equals the JAX permutation word for word.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace ctpu {

constexpr int POSEIDON_RF = 8;

__host__ __device__ constexpr int poseidon_rp(int t) {
  // circomlib's partial-round table (poseidon_constants.N_ROUNDS_P)
  return t == 3 ? 57 : t == 4 ? 56 : t == 5 ? 60 : t == 6 ? 60 : 63;
}

__host__ __device__ constexpr int poseidon_block(int t) {
  return (POSEIDON_RF + poseidon_rp(t)) * t + t * t;
}

// Element offset of width t's block: widths 3..7 in turn, each the round
// constants then the row-major MDS matrix (convert.poseidon_kernel_words).
__host__ __device__ constexpr int poseidon_offset(int t) {
  return t <= 3 ? 0 : poseidon_offset(t - 1) + poseidon_block(t - 1);
}

constexpr int POSEIDON_ELEMS = poseidon_offset(8);  // 1831 elements, 58,592 B
static_assert(POSEIDON_ELEMS * 32 <= 64 * 1024, "constant bank is 64 KiB");

// Each translation unit that runs the permutation holds its own copy and
// uploads it once per device (poseidon_upload).
static __constant__ uint32_t POSEIDON_K[POSEIDON_ELEMS][8];

static inline int poseidon_upload(const uint32_t* host_words, int n_elems) {
  if (n_elems != POSEIDON_ELEMS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(POSEIDON_K, host_words,
                                       sizeof(uint32_t) * 8 * POSEIDON_ELEMS);
  return (int)err;
}

template <int T>
__device__ __forceinline__ void poseidon_permute(uint32_t s[T][8]) {
  constexpr int RP = poseidon_rp(T);
  constexpr int NR = POSEIDON_RF + RP;
  const uint32_t(*C)[8] = POSEIDON_K + poseidon_offset(T);
  const uint32_t(*M)[8] = C + NR * T;
#pragma unroll 1
  for (int r = 0; r < NR; r++) {
#pragma unroll
    for (int i = 0; i < T; i++) fr_add(s[i], s[i], C[r * T + i]);
    if (r < POSEIDON_RF / 2 || r >= POSEIDON_RF / 2 + RP) {
#pragma unroll
      for (int i = 0; i < T; i++) fr_pow5(s[i]);
    } else {
      fr_pow5(s[0]);
    }
    uint32_t n[T][8];
#pragma unroll
    for (int i = 0; i < T; i++) {
      uint32_t prod[8];
      fr_mont_mul(n[i], M[i * T], s[0]);
#pragma unroll
      for (int j = 1; j < T; j++) {
        fr_mont_mul(prod, M[i * T + j], s[j]);
        fr_add(n[i], n[i], prod);
      }
    }
#pragma unroll
    for (int i = 0; i < T; i++) fr_copy(s[i], n[i]);
  }
}

// circomlib Poseidon(2) on canonical inputs: [0, l, r] -> state[0].
__device__ __forceinline__ void poseidon_hash2(uint32_t out[8], const uint32_t l[8],
                                               const uint32_t r[8]) {
  const uint32_t r2[8] = CTPU_R2;
  const uint32_t one[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t s[3][8];
  fr_zero(s[0]);
  fr_mont_mul(s[1], l, r2);
  fr_mont_mul(s[2], r, r2);
  poseidon_permute<3>(s);
  fr_mont_mul(out, s[0], one);
}

}  // namespace ctpu
