// K4: the SHA-256 compression chain, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_sha256.py
// (`_compiled` -> pallas_call of `rounds_body`, entry `sha256_chain`). The
// TPU version computed the message schedule outside the kernel, vectorised
// over blocks (`schedule_w`), and ran only the rounds inside it.
//
// What bounds it on the card: latency. A lane is one serial chain of
// nblocks x 64 rounds, and at the production shape (the rollup HashInputs
// preimage, B = 1 lane, ~822 blocks) that chain is all there is. Nothing of
// a round but the rounds before it has to wait: the message schedule W
// depends on the message alone, and so does K + W. The round is written so
// that what does not depend on the newest e and a is formed early:
//     hx = h + (K + W), dhx = d + hx          (h and d are three rounds old)
//     new e = dhx + Sigma1(e) + Ch(e, f, g)
//     t1    = hx  + Sigma1(e) + Ch(e, f, g)
//     new a = t1  + Sigma0(a) + Maj(a, b, c)
// which leaves three dependent operations from e to the next e (a funnel
// shift, a three-input logic operation, a three-input add).
//
// Two routes, chosen by the lane count B alone (NARROW_LANES_PER_SM):
//  * narrow (B up to 4 lanes an SM): one block a lane, warps specialised.
//    The threads of the producer warps take one message block each: load
//    its 16 words, expand them to 64, add K and store the 64 sums K + W
//    into a ring of STAGES stages of STAGE_BLOCKS message blocks in shared
//    memory. One consumer thread runs the rounds alone, fully unrolled, and
//    reads the next block's K + W (16-byte shared loads) while the current
//    block's rounds run. Stages change hands through mbarriers: `full` from
//    a producer warp to the consumer, `empty` back; there is no block
//    barrier in the loop. A stage costs a producer thread some 600
//    instructions and the consumer tens of microseconds to use up, so the
//    producers stay ahead.
//  * wide (more lanes): one thread a lane with the same round, the schedule
//    expanded in the thread (a 16-word ring in registers), and the next
//    block's words loaded while the current block runs. This is the shape
//    of a batch of withdrawals: HashInputs of Withdraw is 688 bits, 2 blocks
//    a lane, one lane a withdrawal
//    (circuits_tpu/models/hash_inputs.py `hash_inputs_withdrawal`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "funcs.cuh"

__constant__ uint32_t SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// The narrow route serves a batch as long as every consumer warp has a
// scheduler of its own, 4 lanes an SM: there a lane's chain runs at the
// speed of one lane alone. Past that, consumers share schedulers and the
// wide route, whose 32 lanes a warp share every instruction, wins. Measured
// on an NVIDIA H100 (132 SMs, so 528 lanes) at 64 blocks a lane
// (scripts/sha_variants.py routes): narrow 0.065 ms from 1 to 128 lanes and
// 0.070 ms at 528, 0.121 ms at 529 and 0.295 ms at 2,048; wide 0.098-0.102
// ms at every count. Chains of 8 blocks or fewer take the time of a launch
// on either route up to 1,024 lanes.
constexpr int NARROW_LANES_PER_SM = 4;

constexpr int WIDE_THREADS = 128;
constexpr int STAGE_BLOCKS = 32;  // message blocks a stage: one a producer thread
constexpr int STAGES = 3;         // one producer warp each
constexpr int NARROW_THREADS = 32 * (1 + STAGES);
// Words between two message blocks' K + W in a stage: 64 and 4 of padding,
// so that the 16-byte stores of eight neighbouring producer threads fall
// on all 32 banks.
constexpr int KW_STRIDE = 68;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

struct ShaState {
  uint32_t a, b, c, d, e, f, g, h;
};

__device__ __forceinline__ ShaState sha_h0() {
  return {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
          0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
}

// One round on kw = K[i] + W[i].
__device__ __forceinline__ void sha_round(ShaState& s, uint32_t kw) {
  const uint32_t hx = s.h + kw;
  const uint32_t dhx = s.d + hx;
  const uint32_t s1 = rotr(s.e, 6) ^ rotr(s.e, 11) ^ rotr(s.e, 25);
  const uint32_t ch = (s.e & s.f) ^ (~s.e & s.g);
  const uint32_t s0 = rotr(s.a, 2) ^ rotr(s.a, 13) ^ rotr(s.a, 22);
  const uint32_t maj = (s.a & s.b) ^ (s.a & s.c) ^ (s.b & s.c);
  const uint32_t t1 = hx + s1 + ch;
  s.h = s.g;
  s.g = s.f;
  s.f = s.e;
  s.e = dhx + s1 + ch;
  s.d = s.c;
  s.c = s.b;
  s.b = s.a;
  s.a = t1 + s0 + maj;
}

__device__ __forceinline__ void sha_feed_forward(ShaState& h, const ShaState& s) {
  h.a += s.a;
  h.b += s.b;
  h.c += s.c;
  h.d += s.d;
  h.e += s.e;
  h.f += s.f;
  h.g += s.g;
  h.h += s.h;
}

__device__ __forceinline__ void sha_store(int64_t* __restrict__ out, const ShaState& h,
                                          int64_t b, int64_t B) {
  out[b] = (int64_t)h.a;
  out[B + b] = (int64_t)h.b;
  out[2 * B + b] = (int64_t)h.c;
  out[3 * B + b] = (int64_t)h.d;
  out[4 * B + b] = (int64_t)h.e;
  out[5 * B + b] = (int64_t)h.f;
  out[6 * B + b] = (int64_t)h.g;
  out[7 * B + b] = (int64_t)h.h;
}

// W[i] for i >= 16 into the 16-word ring w (w[i & 15] holds W[i - 16]).
__device__ __forceinline__ void sha_expand(uint32_t w[16], int i) {
  const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
}

__device__ __forceinline__ void sha_load_block(uint32_t w[16],
                                               const int64_t* __restrict__ words,
                                               int blk, int64_t b, int64_t B) {
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = (uint32_t)words[((int64_t)blk * 16 + i) * B + b];
}

// ---- the wide route: one thread a lane -------------------------------------

__global__ void __launch_bounds__(WIDE_THREADS)
sha256_chain_wide_kernel(const int64_t* __restrict__ words, int64_t* __restrict__ out,
                         int nblocks, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ShaState h = sha_h0();
  uint32_t next[16];
  sha_load_block(next, words, 0, b, B);
#pragma unroll 1
  for (int blk = 0; blk < nblocks; blk++) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) w[i] = next[i];
    // the next block's words travel while this block's rounds run (the last
    // block loads its own again)
    sha_load_block(next, words, blk + 1 < nblocks ? blk + 1 : blk, b, B);
    ShaState s = h;
#pragma unroll
    for (int i = 0; i < 64; i++) {
      if (i >= 16) sha_expand(w, i);
      sha_round(s, SHA_K[i] + w[i & 15]);
    }
    sha_feed_forward(h, s);
  }
  sha_store(out, h, b, B);
}

// ---- the narrow route: one block a lane, warps specialised -----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive (release): what this thread wrote or read before is ordered
// before what a thread does after its wait on the same phase.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait (acquire) until the barrier's phase of parity `parity` is complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(NARROW_THREADS)
sha256_chain_narrow_kernel(const int64_t* __restrict__ words, int64_t* __restrict__ out,
                           int nblocks, int64_t B) {
  __shared__ __align__(16) uint32_t kw[STAGES][STAGE_BLOCKS * KW_STRIDE];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES];
  const int64_t b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; s++) {
      mbar_init(&full_bar[s], 32);  // every thread of the producer warp
      mbar_init(&empty_bar[s], 1);  // the consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nstages = (nblocks + STAGE_BLOCKS - 1) / STAGE_BLOCKS;

  if (warp > 0) {
    // Producer warp of slot `warp - 1`: stages slot, slot + STAGES, ...
    const int slot = warp - 1;
    int use = 0;  // how often this slot has been filled
#pragma unroll 1
    for (int st = slot; st < nstages; st += STAGES, use++) {
      if (use > 0) mbar_wait(&empty_bar[slot], (use - 1) & 1);
      const int blk = st * STAGE_BLOCKS + lane;
      if (blk < nblocks) {
        uint32_t w[16];
        sha_load_block(w, words, blk, b, B);
        uint4* dst = reinterpret_cast<uint4*>(kw[slot] + lane * KW_STRIDE);
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          uint32_t x[4];
#pragma unroll
          for (int j = 0; j < 4; j++) {
            if (i + j >= 16) sha_expand(w, i + j);
            x[j] = SHA_K[i + j] + w[(i + j) & 15];
          }
          dst[i >> 2] = make_uint4(x[0], x[1], x[2], x[3]);
        }
      }
      mbar_arrive(&full_bar[slot]);
    }
    return;
  }
  if (lane != 0) return;

  // The consumer thread: the rounds and nothing else. x holds the current
  // block's K + W; each group of four is replaced by the next block's as
  // soon as its rounds are done.
  ShaState h = sha_h0();
  uint32_t x[64];
  mbar_wait(&full_bar[0], 0);
  {
    const uint4* src = reinterpret_cast<const uint4*>(kw[0]);
#pragma unroll
    for (int q = 0; q < 16; q++) {
      const uint4 v = src[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
#pragma unroll 1
  for (int blk = 0; blk < nblocks; blk++) {
    // where the next block's K + W lie (the last block reads its own again)
    const int nxt = blk + 1 < nblocks ? blk + 1 : blk;
    const int nst = nxt / STAGE_BLOCKS, nslot = nst % STAGES;
    if (nxt != blk && nxt % STAGE_BLOCKS == 0)
      mbar_wait(&full_bar[nslot], (nst / STAGES) & 1);
    const uint4* src = reinterpret_cast<const uint4*>(
        kw[nslot] + (nxt % STAGE_BLOCKS) * KW_STRIDE);
    ShaState s = h;
#pragma unroll
    for (int i = 0; i < 64; i++) {
      sha_round(s, x[i]);
      if ((i & 3) == 3) {
        const uint4 v = src[i >> 2];
        x[i - 3] = v.x;
        x[i - 2] = v.y;
        x[i - 1] = v.z;
        x[i] = v.w;
      }
    }
    sha_feed_forward(h, s);
    // a stage goes back once the rounds of its last block are done: every
    // word read from it has been used by then
    if (blk % STAGE_BLOCKS == STAGE_BLOCKS - 1)
      mbar_arrive(&empty_bar[(blk / STAGE_BLOCKS) % STAGES]);
  }
  sha_store(out, h, b, B);
}

static cudaError_t narrow_lanes(int* lanes) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *lanes = NARROW_LANES_PER_SM * sms;
  return err;
}

// The largest lane count that the current device serves by the narrow
// route, for the checks that must sit on both sides of it.
extern "C" int ctpu_sha256_narrow_lanes(int* lanes) {
  return (int)narrow_lanes(lanes);
}

extern "C" int ctpu_sha256_chain(const int64_t* words, int64_t* out, int nblocks,
                                 int64_t B, void* stream) {
  if (nblocks < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int narrow = 0;
  const cudaError_t err = narrow_lanes(&narrow);
  if (err != cudaSuccess) return (int)err;
  if (B <= narrow) {
    sha256_chain_narrow_kernel<<<(unsigned)B, NARROW_THREADS, 0, st>>>(words, out,
                                                                        nblocks, B);
  } else {
    const dim3 grid((unsigned)((B + WIDE_THREADS - 1) / WIDE_THREADS));
    sha256_chain_wide_kernel<<<grid, WIDE_THREADS, 0, st>>>(words, out, nblocks, B);
  }
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_sha256_funcs(void** out) {
  const void* k[] = {(const void*)sha256_chain_narrow_kernel,
                     (const void*)sha256_chain_wide_kernel};
  return ctpu::kernel_funcs(k, 2, out);
}
