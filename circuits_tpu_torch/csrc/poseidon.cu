// K1: the Poseidon permutation, t = 3..7, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_poseidon.py
// (`_compiled` -> pallas_call of `_opt_kernel` -> `permute_opt_body`, entry
// `permute_mont`), sparse schedule and all.
//
// What bounds it on the card: operations -- 32-bit integer multiply-adds.
// A permutation is 8 (t^2 + 3t) + R_P (2t + 2) Montgomery products (600 for
// t = 3, 1,568 for t = 7); the 2 * 16 * t * 8 bytes of limb traffic a lane
// are small beside that. But the main path's calls are 2,048 - 8,192 lanes,
// far too few to fill 132 SMs with one thread a lane, so what the design
// has to shorten is the chain of dependent products a thread walks, and it
// has to spread a small batch over the whole card:
//
//  * one thread per state element (poseidon.cuh): a lane is a group of
//    G = 4 (t <= 4) or 8 (t >= 5) threads of one warp. A full round's row
//    of the mix is t products in its thread, and a partial round is 3
//    dependent products whatever t is (4 for t = 4, whose group has no
//    spare thread). Per thread the state is 8 registers, not 8 t, so no
//    width spills;
//  * 64-thread blocks, so 2,048 lanes of t = 7 make 256 blocks and every SM
//    gets warps;
//  * a thread whose element index is >= t (G - t of each group) is a
//    passenger: it runs the same instructions and contributes zero. In a
//    warp that costs instruction slots, not time, while the card is
//    underfilled.
//
// One kernel serves every width: t is a run-time argument, the round loops
// are not unrolled, and the constants come from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "funcs.cuh"
#include "poseidon.cuh"

using namespace ctpu;

constexpr int K1_THREADS = 64;

template <int G>
__global__ void __launch_bounds__(K1_THREADS)
poseidon_permute_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                        const uint32_t* __restrict__ tab, int t, int64_t B) {
  const int64_t tid = (int64_t)blockIdx.x * K1_THREADS + threadIdx.x;
  const int64_t b = tid / G;
  const int i = (int)(tid % G);
  const bool live = b < B && i < t;
  // layout (16, t, B): limb l of element i of lane b at (l * t + i) * B + b
  uint32_t s[8];
  fr_zero(s);
  if (live) {
#pragma unroll
    for (int k = 0; k < 8; k++)
      s[k] = (uint32_t)in[((2 * k) * t + i) * B + b] |
             ((uint32_t)in[((2 * k + 1) * t + i) * B + b] << 16);
  }
  poseidon_permute_group<G>(s, tab, t, i);
  if (live) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      out[((2 * k) * t + i) * B + b] = (int64_t)(s[k] & 0xffffu);
      out[((2 * k + 1) * t + i) * B + b] = (int64_t)(s[k] >> 16);
    }
  }
}

// `tab` is the whole constant table (convert.poseidon_kernel_words) in
// device memory, n_elems elements of 8 words.
extern "C" int ctpu_poseidon_permute(const int64_t* in, int64_t* out,
                                     const uint32_t* tab, int n_elems, int t,
                                     int64_t B, void* stream) {
  if (n_elems != SPARSE_ELEMS || t < 3 || t > 7 || B < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t* block = tab + 8 * sparse_offset(t);
  cudaStream_t st = (cudaStream_t)stream;
  if (t <= 4) {
    const int64_t threads = B * 4;
    const dim3 grid((unsigned)((threads + K1_THREADS - 1) / K1_THREADS));
    poseidon_permute_kernel<4><<<grid, K1_THREADS, 0, st>>>(in, out, block, t, B);
  } else {
    const int64_t threads = B * 8;
    const dim3 grid((unsigned)((threads + K1_THREADS - 1) / K1_THREADS));
    poseidon_permute_kernel<8><<<grid, K1_THREADS, 0, st>>>(in, out, block, t, B);
  }
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_poseidon_funcs(void** out) {
  const void* k[] = {(const void*)poseidon_permute_kernel<4>,
                     (const void*)poseidon_permute_kernel<8>};
  return kernel_funcs(k, 2, out);
}
