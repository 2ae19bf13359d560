// K5 and K6: R consecutive Poseidon t = 3 full rounds (ARK with the
// optimized schedule's full_c[r % 8], x^5 on every element, then the MDS
// mix new[i] = sum_j M[i][j] * state[j]), batched over lanes. State
// (16, 3, B) int64 Montgomery limbs in and out, canonical.
//
// K5 replaces the Pallas TPU kernel scripts/exp_mxu_inkernel.py `call_vpu`
// (`_kernel_vpu`, the production round `pallas_poseidon.opt_full_round`).
// One thread per lane keeps the 3 x 8 words of state in registers for all
// R rounds and computes the mix as nine Montgomery products (field.cuh's
// fr_mont_mul). Bound by integer multiply throughput: 18 Montgomery
// products a round.
//
// K6 replaces `call_mxu` (`_kernel_mxu` / `_mxu_round_body`), which puts
// the mix and its Montgomery reduction on the TPU's matrix unit. Here they
// go to the tensor cores as u8 x u8 -> s32 products (mma.sync m16n8k32):
//   T  = Wm . X     (192 x 96) . (96 x lanes): the 64 byte columns of
//                   T_e = sum_j M[e][j] * s_j for each element e;
//   q  = Wn . lo    (32 x 32) per element: lo * N' mod 2^256;
//   qp = Wp . q     (64 x 32) per element: q * p (Wp's rows 63 and 64 are
//                   zero, so its first 64 rows are the whole product).
// ARK and x^5 stay on the CUDA cores, one thread per (element, lane). Each
// thread then ripples its own element's carries through 64, 32 and 64
// columns read from shared memory and finishes with a real conditional
// subtract of p ((T + q p) / 2^256 < 1.6 p for t = 3), so K6's output
// equals K5's word for word. The TPU kernel's Kogge-Stone carry prefix and
// block-diagonal dots served the vector unit's depth and sublanes and are
// not carried over. What bounds K6 is the CUDA-core work left (x^5, the
// byte ripples) and six block barriers a round, not the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace ctpu;

namespace {

constexpr int T3 = 3;
constexpr int RF = 8;
constexpr int ROUNDS_ELEMS = RF * T3 + T3 * T3;  // full_c, then M

// Montgomery words: full_c[r][i] at r * 3 + i, then M[i][j] at 24 + 3 i + j
// (convert.rounds_kernel_words).
__constant__ uint32_t ROUNDS_K[ROUNDS_ELEMS][8];

__device__ __forceinline__ void load_elem(uint32_t s[8], const int64_t* __restrict__ in,
                                          int e, int64_t b, int64_t B) {
#pragma unroll
  for (int k = 0; k < 8; k++)
    s[k] = (uint32_t)in[((2 * k) * T3 + e) * B + b] |
           ((uint32_t)in[((2 * k + 1) * T3 + e) * B + b] << 16);
}

__device__ __forceinline__ void store_elem(int64_t* __restrict__ out, const uint32_t s[8],
                                           int e, int64_t b, int64_t B) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    out[((2 * k) * T3 + e) * B + b] = (int64_t)(s[k] & 0xffffu);
    out[((2 * k + 1) * T3 + e) * B + b] = (int64_t)(s[k] >> 16);
  }
}

__device__ __forceinline__ void ark_pow5(uint32_t s[8], int r, int e) {
  fr_add(s, s, ROUNDS_K[(r % RF) * T3 + e]);
  fr_pow5(s);
}

// ---------------------------------------------------------------- K5

__global__ void __launch_bounds__(128)
rounds_vpu_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int rounds,
                  int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t s[T3][8];
#pragma unroll
  for (int i = 0; i < T3; i++) load_elem(s[i], in, i, b, B);
  const uint32_t(*M)[8] = ROUNDS_K + RF * T3;
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
#pragma unroll
    for (int i = 0; i < T3; i++) ark_pow5(s[i], r, i);
    uint32_t n[T3][8];
#pragma unroll
    for (int i = 0; i < T3; i++) {
      uint32_t prod[8];
      fr_mont_mul(n[i], M[i * T3], s[0]);
#pragma unroll
      for (int j = 1; j < T3; j++) {
        fr_mont_mul(prod, M[i * T3 + j], s[j]);
        fr_add(n[i], n[i], prod);
      }
    }
#pragma unroll
    for (int i = 0; i < T3; i++) fr_copy(s[i], n[i]);
  }
#pragma unroll
  for (int i = 0; i < T3; i++) store_elem(out, s[i], i, b, B);
}

// ---------------------------------------------------------------- K6

constexpr int MX_LANES = 32;                   // lanes per block
constexpr int MX_THREADS = T3 * MX_LANES;      // one thread per (element, lane)
constexpr int MX_WARPS = MX_THREADS / 32;
constexpr int MX_COLS = T3 * MX_LANES;         // columns of the q and q*p products
constexpr int X_STRIDE = T3 * 32 + 4;          // bytes per lane row of X (odd word count)
constexpr int L_STRIDE = 32 + 4;               // bytes per column of lo / q
constexpr int ACC_MIX = MX_LANES + 8;          // int32 per row of T
constexpr int ACC_RED = MX_COLS + 8;           // int32 per row of q, q*p
constexpr int ACC_WORDS = (T3 * 64 * ACC_MIX > 64 * ACC_RED) ? T3 * 64 * ACC_MIX
                                                             : 64 * ACC_RED;

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one 16 x 8 tile, depth 32, u8 operands, s32 sums.
__device__ __forceinline__ void mma_m16n8k32_u8(int32_t d[4], const uint32_t a[4],
                                                const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] = sum_k A[m][k] * Bt[n][k] for m < M, n < N, k < K: A row major
// in global memory (K bytes a row, read through the read-only cache), Bt in
// shared memory one column n per `ldb` bytes, acc in shared memory `ldc`
// words a row. The block's warps take the 16 x 8 tiles in turn. Fragment
// layouts are those of mma.m16n8k32 (PTX ISA): with g = lane / 4 and
// c = lane % 4, A's registers hold rows g, g + 8 at depth 4c..4c+3 and
// 16 + 4c..; B's hold column g at the same depths; D holds rows g, g + 8 at
// columns 2c, 2c + 1.
template <int M, int N, int K>
__device__ __forceinline__ void mma_u8_product(const uint8_t* __restrict__ A,
                                               const uint8_t* Bt, int ldb, int32_t* acc,
                                               int ldc) {
  static_assert(M % 16 == 0 && N % 8 == 0 && K % 32 == 0, "tile shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  constexpr int NT = N / 8, TILES = (M / 16) * NT;
#pragma unroll 1
  for (int tile = warp; tile < TILES; tile += MX_WARPS) {
    const int m0 = (tile / NT) * 16, n0 = (tile % NT) * 8;
    const uint8_t* a_lo = A + (m0 + g) * K + 4 * c;
    const uint8_t* a_hi = a_lo + 8 * K;
    const uint8_t* bp = Bt + (n0 + g) * ldb + 4 * c;
    int32_t d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 32) {
      const uint32_t a[4] = {ldg32(a_lo + k0), ldg32(a_hi + k0), ldg32(a_lo + k0 + 16),
                             ldg32(a_hi + k0 + 16)};
      const uint32_t bb[2] = {lds32(bp + k0), lds32(bp + k0 + 16)};
      mma_m16n8k32_u8(d, a, bb);
    }
    int32_t* out = acc + (m0 + g) * ldc + n0 + 2 * c;
    out[0] = d[0];
    out[1] = d[1];
    out[8 * ldc] = d[2];
    out[8 * ldc + 1] = d[3];
  }
}

// Base-256 carries through N columns col[k * stride] (each < 2^23), ripple
// order; the N bytes are packed little-endian into w[N / 4]. The carry out
// of the top column is dropped (the value is taken mod 2^(8N)).
template <int N>
__device__ __forceinline__ void ripple_bytes(uint32_t w[N / 4], const int32_t* col,
                                             int stride) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint32_t v = (uint32_t)col[k * stride] + carry;
    if ((k & 3) == 0) w[k >> 2] = 0u;
    w[k >> 2] |= (v & 255u) << (8 * (k & 3));
    carry = v >> 8;
  }
}

__global__ void __launch_bounds__(MX_THREADS)
rounds_mxu_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  const uint8_t* __restrict__ wm, const uint8_t* __restrict__ wn,
                  const uint8_t* __restrict__ wp, int rounds, int64_t B) {
  __shared__ __align__(16) uint8_t xs[MX_LANES * X_STRIDE];  // X: lane n's 96 bytes
  __shared__ __align__(16) uint8_t ls[MX_COLS * L_STRIDE];   // lo, then q: column tid
  __shared__ __align__(16) int32_t acc[ACC_WORDS];           // product columns
  const int tid = threadIdx.x;
  const int e = tid / MX_LANES, n = tid % MX_LANES;
  const int64_t b = (int64_t)blockIdx.x * MX_LANES + n;
  const bool live = b < B;  // the ragged tail computes on zeros, stores nothing
  uint32_t s[8];
  if (live) {
    load_elem(s, in, e, b, B);
  } else {
    fr_zero(s);
  }
  // little-endian words are the byte columns: word k holds bytes 4k..4k+3
  uint32_t* xrow = reinterpret_cast<uint32_t*>(xs + n * X_STRIDE + 32 * e);
  uint32_t* lcol = reinterpret_cast<uint32_t*>(ls + tid * L_STRIDE);
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
    ark_pow5(s, r, e);
#pragma unroll
    for (int k = 0; k < 8; k++) xrow[k] = s[k];
    __syncthreads();
    mma_u8_product<T3 * 64, MX_LANES, T3 * 32>(wm, xs, X_STRIDE, acc, ACC_MIX);
    __syncthreads();
    uint32_t tw[16];  // the 64 bytes of T_e (< 3 p^2 < 2^512)
    ripple_bytes<64>(tw, acc + e * 64 * ACC_MIX + n, ACC_MIX);
#pragma unroll
    for (int k = 0; k < 8; k++) lcol[k] = tw[k];
    __syncthreads();
    mma_u8_product<32, MX_COLS, 32>(wn, ls, L_STRIDE, acc, ACC_RED);
    __syncthreads();
    uint32_t q[8];
    ripple_bytes<32>(q, acc + tid, ACC_RED);
#pragma unroll
    for (int k = 0; k < 8; k++) lcol[k] = q[k];
    __syncthreads();
    mma_u8_product<64, MX_COLS, 32>(wp, ls, L_STRIDE, acc, ACC_RED);
    __syncthreads();
    // T + q p: its low 32 bytes are zero; the high 32 are the reduced value
    uint32_t h[8];
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 64; k++) {
      const uint32_t v =
          ((tw[k >> 2] >> (8 * (k & 3))) & 255u) + (uint32_t)acc[k * ACC_RED + tid] + carry;
      if (k >= 32) {
        if ((k & 3) == 0) h[(k - 32) >> 2] = 0u;
        h[(k - 32) >> 2] |= (v & 255u) << (8 * (k & 3));
      }
      carry = v >> 8;
    }
    fr_reduce_once(s, h, carry);
  }
  if (live) store_elem(out, s, e, b, B);
}

}  // namespace

extern "C" int ctpu_rounds_init(const uint32_t* host_words, int n_elems) {
  if (n_elems != ROUNDS_ELEMS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(ROUNDS_K, host_words, sizeof(uint32_t) * 8 * ROUNDS_ELEMS);
}

extern "C" int ctpu_rounds_vpu(const int64_t* in, int64_t* out, int rounds, int64_t B,
                               void* stream) {
  if (B <= 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  rounds_vpu_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(in, out, rounds, B);
  return (int)cudaGetLastError();
}

extern "C" int ctpu_rounds_mxu(const int64_t* in, int64_t* out, const uint8_t* wm,
                               const uint8_t* wn, const uint8_t* wp, int rounds, int64_t B,
                               void* stream) {
  if (B <= 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + MX_LANES - 1) / MX_LANES));
  rounds_mxu_kernel<<<grid, MX_THREADS, 0, (cudaStream_t)stream>>>(in, out, wm, wn, wp,
                                                                   rounds, B);
  return (int)cudaGetLastError();
}
