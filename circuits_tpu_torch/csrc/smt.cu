// K2: the SMT processor's bottom-up hash chains, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_smt.py
// (`_compiled` -> pallas_call of `_kernel` -> `chain_body`, entry
// `processor_chain`). One thread per lane walks the n levels in a loop and
// carries the old and new chain values in registers; nothing is carried
// between blocks. Per level it forms the three Poseidon(2) instances of
// the JAX kernel (old chain, new chain, bottom pair) with K1's t = 3
// permutation as a device function, then applies the five state-machine
// masks (top / old0 / bot / new1 / upd). A hash whose result no mask can
// select at this level (old and new chain need `top`, the bottom pair
// needs `bot`) is skipped: the outputs are the same, and below a lane's
// action level no hash runs at all.
//
// What bounds it on the card: integer multiply issue inside the
// permutations (~780 Montgomery products each, 2 - 3 per active level).
// At the production shape B = 2 * nTx = 4096 lanes fill only ~32 of the
// 132 SMs with one 128-thread block each; spreading the three hashes of a
// level over three threads is the obvious next step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "poseidon.cuh"

using namespace ctpu;

__global__ void __launch_bounds__(128)
smt_chain_kernel(const int64_t* __restrict__ sib, const uint8_t* __restrict__ bits,
                 const uint8_t* __restrict__ masks, const int64_t* __restrict__ old1,
                 const int64_t* __restrict__ new1, const int64_t* __restrict__ new1h,
                 int64_t* __restrict__ out, int n, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t o1[8], n1[8], n1h[8], oldc[8], newc[8], zero[8];
  fr_load(o1, old1, b, B);
  fr_load(n1, new1, b, B);
  fr_load(n1h, new1h, b, B);
  fr_zero(oldc);
  fr_zero(newc);
  fr_zero(zero);
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    uint32_t s[8];
    fr_load(s, sib + (int64_t)i * 16 * B, b, B);
    const bool bit = bits[(int64_t)i * B + b] != 0;
    const uint8_t* m = masks + (int64_t)i * 5 * B + b;
    const bool top = m[0] != 0, old0 = m[B] != 0, bot = m[2 * B] != 0,
               new1m = m[3 * B] != 0, upd = m[4 * B] != 0;
    uint32_t oh[8], nh[8], bh[8], l[8], r[8];
    fr_zero(oh);
    fr_zero(nh);
    fr_zero(bh);
    if (top) {
      fr_select(l, bit, s, oldc);
      fr_select(r, bit, oldc, s);
      poseidon_hash2(oh, l, r);
      fr_select(l, bit, s, newc);
      fr_select(r, bit, newc, s);
      poseidon_hash2(nh, l, r);
    }
    if (bot) {
      fr_select(l, bit, zero, newc);
      fr_select(r, bit, newc, zero);
      poseidon_hash2(bh, l, r);
    }
    // old chain
    fr_select(oldc, top, oh, zero);
    if (bot || new1m || upd) fr_copy(oldc, o1);
    // new chain
    uint32_t nu[8];
    fr_select(nu, top, nh, zero);
    if (bot) fr_copy(nu, bh);
    if (new1m) fr_copy(nu, n1h);
    if (old0 || upd) fr_copy(nu, n1);
    fr_copy(newc, nu);
  }
  fr_store(out, oldc, b, B);
  fr_store(out + 16 * B, newc, b, B);
}

extern "C" int ctpu_smt_init(const uint32_t* host_words, int n_elems) {
  return poseidon_upload(host_words, n_elems);
}

extern "C" int ctpu_smt_chain(const int64_t* sib, const uint8_t* bits,
                              const uint8_t* masks, const int64_t* old1,
                              const int64_t* new1, const int64_t* new1h,
                              int64_t* out, int n, int64_t B, void* stream) {
  const int threads = 128;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  smt_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      sib, bits, masks, old1, new1, new1h, out, n, B);
  return (int)cudaGetLastError();
}
