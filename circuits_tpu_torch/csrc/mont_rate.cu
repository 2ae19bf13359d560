// A measuring kernel, on no path of the port: the card's rate of
// `fr_mont_mul` (field.cuh), the unit in which the Poseidon, SMT and EdDSA
// kernels' bounds are reckoned. Every thread walks C independent chains
// x_c <- x_c * y_c for `iters` steps, so C products are in flight a thread.
// A grid of many 256-thread blocks on every SM keeps all four schedulers of
// an SM busy and gives the sustained rate (products = C * iters * threads);
// one 128-thread block an SM with C = 1 leaves each scheduler one warp and
// gives the time of one product in a chain of dependent ones.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace ctpu;

template <int C>
__global__ void __launch_bounds__(256)
mont_rate_kernel(uint32_t* __restrict__ out, int iters) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[C][8], y[C][8];
#pragma unroll
  for (int c = 0; c < C; c++)
#pragma unroll
    for (int k = 0; k < 8; k++) {
      // any canonical values do: the top word stays below p's
      x[c][k] = k == 7 ? (tid & 0x0fffffffu) : tid * (2 * k + 3) + c;
      y[c][k] = k == 7 ? 0x10000000u + c : tid * (2 * k + 5) + 7 * c + 1;
    }
#pragma unroll 1
  for (int it = 0; it < iters; it++)
#pragma unroll
    for (int c = 0; c < C; c++) fr_mont_mul(x[c], x[c], y[c]);
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < C; c++)
#pragma unroll
    for (int k = 0; k < 8; k++) acc ^= x[c][k];
  out[tid] = acc;
}

// Launches blocks x threads (at most 256); `out` holds blocks * threads
// words.
extern "C" int ctpu_mont_rate(uint32_t* out, int chains, int blocks, int threads,
                              int iters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (threads < 1 || threads > 256) return (int)cudaErrorInvalidValue;
  switch (chains) {
    case 1: mont_rate_kernel<1><<<blocks, threads, 0, st>>>(out, iters); break;
    case 2: mont_rate_kernel<2><<<blocks, threads, 0, st>>>(out, iters); break;
    case 4: mont_rate_kernel<4><<<blocks, threads, 0, st>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
