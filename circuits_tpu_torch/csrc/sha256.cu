// K4: the SHA-256 compression chain, batched over lanes.
//
// Replaces the Pallas TPU kernel circuits_tpu/ops/pallas_sha256.py
// (`_compiled` -> pallas_call of `rounds_body`, entry `sha256_chain`). The
// TPU version computed the message schedule outside the kernel, vectorised
// over blocks; here one thread per lane runs the whole chain and expands W
// block by block in a 16-word ring in registers, so the kernel reads each
// message word once and writes only the final 8-word state.
//
// What bounds it on the card: latency. At the production shape (the
// rollup HashInputs preimage, B = 1 lane, ~822 blocks) it is one serial
// chain of 64 dependent rounds per block on one thread; the card is
// otherwise idle. Wide batches with few blocks (batched Withdraw) get one
// thread per lane and so fill the card as B grows.
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__global__ void __launch_bounds__(128)
sha256_chain_kernel(const int64_t* __restrict__ words, int64_t* __restrict__ out,
                    int nblocks, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
#pragma unroll 1
  for (int blk = 0; blk < nblocks; blk++) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t)words[((int64_t)blk * 16 + i) * B + b];
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
             hh = h[7];
#pragma unroll
    for (int i = 0; i < 64; i++) {
      if (i >= 16) {
        const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      }
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i & 15];
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint32_t t2 = S0 + maj;
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + t2;
    }
    h[0] += a;
    h[1] += bb;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
  }
#pragma unroll
  for (int k = 0; k < 8; k++) out[(int64_t)k * B + b] = (int64_t)h[k];
}

extern "C" int ctpu_sha256_chain(const int64_t* words, int64_t* out, int nblocks,
                                 int64_t B, void* stream) {
  const int threads = 128;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  sha256_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(words, out, nblocks,
                                                                   B);
  return (int)cudaGetLastError();
}
