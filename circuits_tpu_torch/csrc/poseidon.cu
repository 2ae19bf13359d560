// K1: the Poseidon permutation, t = 3..7, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_poseidon.py
// (`_compiled` -> pallas_call of `_opt_kernel` / `_kernel`, entry
// `permute_mont`). One thread per lane keeps the whole t-element state in
// registers (t * 8 words) for all 8 + R_P rounds; the round constants and
// MDS matrices sit in __constant__ memory, where every lane of a warp reads
// the same word (a broadcast).
//
// What bounds it on the card: integer multiply issue. A t = 3 permutation
// is ~65 * (3 S-box + t^2 mix) ~ 780 Montgomery products of 128 32-bit
// multiply-adds each; the 16 * t * 8-byte limb traffic per lane is
// negligible beside that. This first version uses the dense schedule; the
// sparse partial-round schedule (poseidon_constants.optimized_constants)
// cuts the partial rounds from t^2 to 2t - 1 products and is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "poseidon.cuh"

using namespace ctpu;

template <int T>
__global__ void __launch_bounds__(128)
poseidon_permute_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                        int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // layout (16, T, B): limb l of element i of lane b at (l * T + i) * B + b
  uint32_t s[T][8];
#pragma unroll
  for (int i = 0; i < T; i++)
#pragma unroll
    for (int k = 0; k < 8; k++)
      s[i][k] = (uint32_t)in[((2 * k) * T + i) * B + b] |
                ((uint32_t)in[((2 * k + 1) * T + i) * B + b] << 16);
  poseidon_permute<T>(s);
#pragma unroll
  for (int i = 0; i < T; i++)
#pragma unroll
    for (int k = 0; k < 8; k++) {
      out[((2 * k) * T + i) * B + b] = (int64_t)(s[i][k] & 0xffffu);
      out[((2 * k + 1) * T + i) * B + b] = (int64_t)(s[i][k] >> 16);
    }
}

extern "C" int ctpu_poseidon_init(const uint32_t* host_words, int n_elems) {
  return poseidon_upload(host_words, n_elems);
}

extern "C" int ctpu_poseidon_permute(const int64_t* in, int64_t* out, int t,
                                     int64_t B, void* stream) {
  const int threads = 128;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  cudaStream_t st = (cudaStream_t)stream;
  switch (t) {
    case 3: poseidon_permute_kernel<3><<<grid, threads, 0, st>>>(in, out, B); break;
    case 4: poseidon_permute_kernel<4><<<grid, threads, 0, st>>>(in, out, B); break;
    case 5: poseidon_permute_kernel<5><<<grid, threads, 0, st>>>(in, out, B); break;
    case 6: poseidon_permute_kernel<6><<<grid, threads, 0, st>>>(in, out, B); break;
    case 7: poseidon_permute_kernel<7><<<grid, threads, 0, st>>>(in, out, B); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
