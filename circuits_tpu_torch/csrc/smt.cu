// K2: the SMT processor's bottom-up hash chains, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_smt.py
// (`_compiled` -> pallas_call of `_kernel` -> `chain_body`, entry
// `processor_chain`).
//
// What bounds it on the card: operations -- the Montgomery products of the
// Poseidon(2) permutations (600 each in the sparse schedule, plus 3 to
// enter and leave Montgomery form) -- and, since the n levels of a lane are
// a serial chain and the main path has only 4,096 lanes, the length of the
// chain of dependent products: n levels times one permutation's critical
// path is the floor of the kernel's latency.
//
// Design: 8 threads a lane, 4 lanes a warp.
//  * The JAX kernel forms three Poseidon(2) a level: old chain, new chain
//    and bottom pair. The masks select the old and new chain hashes only
//    under `top`, the bottom pair only under `bot`, and where both are set
//    `bot` wins the new chain and the old chain takes its leaf. So two
//    hashes side by side serve every combination of masks: group 0 hashes
//    the old chain, group 1 the bottom pair under `bot` and the new chain
//    otherwise. Each is a 4-thread group of poseidon.cuh (t = 3 and one
//    passenger); the two run in the same instructions of one warp.
//  * Both chain values live in all 8 threads of a lane; after a level the
//    two results are shuffled to all 8 and every thread applies the five
//    masks itself.
//  * A level at which no lane of the warp has `top` or `bot` set hashes
//    nothing (below a lane's action level no mask is set). The test is a
//    warp vote, so all 32 threads reach the same shuffles.
//  * The three leaves are read where a mask selects them, not held in
//    registers over the chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "funcs.cuh"
#include "poseidon.cuh"

using namespace ctpu;

constexpr int K2_THREADS = 64;
constexpr int K2_GROUP = 8;  // threads a lane: 2 hashes x 4

__global__ void __launch_bounds__(K2_THREADS)
smt_chain_kernel(const int64_t* __restrict__ sib, const uint8_t* __restrict__ bits,
                 const uint8_t* __restrict__ masks, const int64_t* __restrict__ old1,
                 const int64_t* __restrict__ new1, const int64_t* __restrict__ new1h,
                 int64_t* __restrict__ out, const uint32_t* __restrict__ tab3,
                 int n, int64_t B) {
  const int64_t tid = (int64_t)blockIdx.x * K2_THREADS + threadIdx.x;
  const int sub = (int)(tid % K2_GROUP);
  const int hash = sub >> 2, i = sub & 3;
  const bool live = tid / K2_GROUP < B;
  // a dead lane at the ragged end walks lane B - 1 again and stores nothing
  const int64_t b = live ? tid / K2_GROUP : B - 1;
  const int lane_base = (threadIdx.x & 31) & ~(K2_GROUP - 1);
  const uint32_t r2[8] = CTPU_R2;
  const uint32_t one[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t oldc[8], newc[8], zero[8];
  fr_zero(oldc);
  fr_zero(newc);
  fr_zero(zero);
#pragma unroll 1
  for (int lvl = 0; lvl < n; lvl++) {
    const uint8_t* m = masks + (int64_t)lvl * 5 * B + b;
    const bool top = m[0] != 0, old0 = m[B] != 0, bot = m[2 * B] != 0,
               new1m = m[3 * B] != 0, upd = m[4 * B] != 0;
    uint32_t oh[8], xh[8];
    fr_zero(oh);
    fr_zero(xh);
    if (__any_sync(FULL_WARP, top || bot)) {
      uint32_t s[8], x[8];
      fr_load(s, sib + (int64_t)lvl * 16 * B, b, B);
      const bool bit = bits[(int64_t)lvl * B + b] != 0;
      // [0, l, r]: the chain value on the side the key's bit names
      const bool bottom = hash == 1 && bot;
      fr_select(s, bottom, zero, s);
      fr_select(x, hash == 0, oldc, newc);
      fr_select(x, (i == 1) == bit, s, x);
      if (i == 0 || i == 3) fr_zero(x);
      fr_mont_mul(x, x, r2);
      poseidon_permute_group<4>(x, tab3, 3, i);
      fr_mont_mul(x, x, one);
      fr_shfl(oh, x, lane_base);
      fr_shfl(xh, x, lane_base + 4);
    }
    // old chain
    fr_select(oldc, top, oh, zero);
    if (bot || new1m || upd) fr_load(oldc, old1, b, B);
    // new chain
    fr_select(newc, top || bot, xh, zero);
    if (new1m) fr_load(newc, new1h, b, B);
    if (old0 || upd) fr_load(newc, new1, b, B);
  }
  if (live && sub == 0) {
    fr_store(out, oldc, b, B);
    fr_store(out + 16 * B, newc, b, B);
  }
}

// `tab` is the whole constant table (convert.poseidon_kernel_words) in
// device memory, n_elems elements of 8 words.
extern "C" int ctpu_smt_chain(const int64_t* sib, const uint8_t* bits,
                              const uint8_t* masks, const int64_t* old1,
                              const int64_t* new1, const int64_t* new1h,
                              int64_t* out, const uint32_t* tab, int n_elems,
                              int n, int64_t B, void* stream) {
  if (n_elems != SPARSE_ELEMS || n < 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = B * K2_GROUP;
  const dim3 grid((unsigned)((threads + K2_THREADS - 1) / K2_THREADS));
  smt_chain_kernel<<<grid, K2_THREADS, 0, (cudaStream_t)stream>>>(
      sib, bits, masks, old1, new1, new1h, out, tab + 8 * sparse_offset(3), n, B);
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_smt_funcs(void** out) {
  const void* k[] = {(const void*)smt_chain_kernel};
  return kernel_funcs(k, 1, out);
}
