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
// K6 replaces the Pallas TPU kernel scripts/exp_mxu_inkernel.py:220
// `call_mxu` (`_kernel_mxu` / `_mxu_round_body`), which puts
// the mix and its Montgomery reduction on the TPU's matrix unit. Here the
// mix T_e = sum_j M'[e][j] * s_j (M' = M R mod p) goes to the tensor cores
// as a u8 x u8 -> s32 product (mma.sync m16n8k32) on 8-bit limbs, and the
// rest of the round stays on the CUDA cores.
//
// What bounds K6 on this card: integer issue on the CUDA cores. The nine
// Montgomery products of x^5 a lane and round are the floor (the tensor
// cores' share of the bound is about a sixth), so the mix pays only if its
// CUDA-core side (carries, reduction, data movement) stays well under K5's
// nine products: byte-at-a-time carry ripples alone would cost more than
// x^5, and block barriers would idle the SM between the phases.
//
// Design (one thread a lane, a warp owns 32 lanes end to end; the only
// block barrier is the staging of Wm before the round loop):
//  * ARK and x^5 as in K5; the thread writes its 3 x 8 words to the warp's
//    own X tile (a lane a row). Little-endian words are byte columns, so the
//    A fragments of X^T (lanes as the product's M dimension, the 96 state
//    bytes as K) are words c and c + 4 of a lane row.
//  * The product X^T . Wm^T, 16 lanes by 192 columns a tile, with Wm^T's B
//    fragments staged once per block in shared memory in fragment order
//    (convert.mix_fragments). Its output columns are permuted so that the
//    thread in place c of a quad holds bytes 16c .. 16c + 15 of T_e for its
//    two rows: each pair of n-tiles gives it one whole 32-bit word.
//  * Word carries, not byte ripples: the thread folds four byte columns
//    (each < 96 * 255^2 < 2^23) into one 48-bit word lo + hi 2^32, and its
//    four words into 128 bits and a top word (a PTX carry chain). The lane's
//    thread reads the four quarters back from the warp's V tile (swizzled:
//    no bank conflicts on either side) and joins them in one 16-word carry
//    chain: T_e, 512 bits.
//  * The Montgomery reduction on the CUDA cores, eight word rows
//    m = a_0 N0, a = (a + m p) / 2^32 on T's low half, then T's high half
//    added: (T + q p) / 2^256 < 1.6 p, and one conditional subtract of p,
//    so K6's output equals K5's word for word.
// Two __syncwarp a round order the X and V tiles; no block barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "funcs.cuh"

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

constexpr int MX_WARPS = 8;                     // warps a block, 32 lanes each
constexpr int MX_THREADS = 32 * MX_WARPS;       // one thread a lane
constexpr int MX_FRAGS = T3 * 8 * T3;           // (element, n-tile, k-step)
constexpr int X_STRIDE = 28;                    // words a lane row of X (24 + 4)
constexpr int VLO_STRIDE = 48;                  // words a lane row of V's quarters
constexpr int VHI_STRIDE = 12;                  // words a lane row of V's top words
constexpr int WARP_WORDS = 32 * (X_STRIDE + VLO_STRIDE + VHI_STRIDE);
constexpr int MX_SMEM = MX_FRAGS * 32 * 8 + MX_WARPS * WARP_WORDS * 4;

// d += a . b for one 16 x 8 tile, depth 32, u8 operands, s32 sums. Fragment
// layouts of mma.m16n8k32 (PTX ISA), with g = lane / 4 and c = lane % 4:
// a0..a3 hold A's rows g, g + 8, g, g + 8 at depths 4c..4c+3, 4c.., 16 + 4c..,
// 16 + 4c..; b.x and b.y hold B's column g at depths 4c.. and 16 + 4c..
// (lower depth in the lower byte); d0..d3 hold D's rows g, g, g + 8, g + 8 at
// columns 2c, 2c + 1, 2c, 2c + 1.
__device__ __forceinline__ void mma_m16n8k32_u8(int32_t d[4], const uint32_t a[4],
                                                uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// lo + hi 2^32 = c0 + c1 2^8 + c2 2^16 + c3 2^24 for four byte columns, each
// below 2^23 (so c0 + c1 2^8 < 2^32 and hi < 2^16).
__device__ __forceinline__ void fold_word(uint32_t& lo, uint32_t& hi, int32_t c0,
                                          int32_t c1, int32_t c2, int32_t c3) {
  asm("{\n\t.reg .u32 x;\n\t"
      "mad.lo.u32 x, %3, 256, %2;\n\t"
      "mad.lo.cc.u32 %0, %4, 65536, x;\n\t"
      "madc.hi.u32 %1, %4, 65536, 0;\n\t"
      "mad.lo.cc.u32 %0, %5, 16777216, %0;\n\t"
      "madc.hi.u32 %1, %5, 16777216, %1;\n\t}"
      : "=&r"(lo), "=&r"(hi)
      : "r"(c0), "r"(c1), "r"(c2), "r"(c3));
}

// v[0..4] = sum_u (lo[u] + hi[u] 2^32) 2^(32 u): a quarter's four words and
// its top word (< 2^17).
__device__ __forceinline__ void quarter_words(uint32_t v[5], const uint32_t lo[4],
                                              const uint32_t hi[4]) {
  v[0] = lo[0];
  asm("add.cc.u32 %0, %4, %7;\n\t"
      "addc.cc.u32 %1, %5, %8;\n\t"
      "addc.cc.u32 %2, %6, %9;\n\t"
      "addc.u32 %3, %10, 0;"
      : "=&r"(v[1]), "=&r"(v[2]), "=&r"(v[3]), "=&r"(v[4])
      : "r"(lo[1]), "r"(lo[2]), "r"(lo[3]), "r"(hi[0]), "r"(hi[1]), "r"(hi[2]),
        "r"(hi[3]));
}

// t[0..15] holds the quarters' words (quarter q at 4q); adds quarter q's top
// word h[q] at word 4q + 4 in one carry chain. The carry out of word 15 and
// the last top word are dropped: the value is taken mod 2^512.
__device__ __forceinline__ void join_quarters(uint32_t t[16], uint32_t h0, uint32_t h1,
                                              uint32_t h2) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.cc.u32 %8, %8, %14;\n\t"
      "addc.cc.u32 %9, %9, 0;\n\t"
      "addc.cc.u32 %10, %10, 0;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(h0), "r"(h1), "r"(h2));
}

// r = (T + q p) / 2^256 mod p for T < 3 p^2 (16 words), q = -T p^-1 mod
// 2^256: eight word rows on T's low half a (m = a_0 N0, then
// a = (a + m p) / 2^32, the products of p's even words on aligned pairs of a
// and those of its odd words on aligned pairs of the shifted sum), then T's
// high half added; a <= p + 1 and T / 2^256 < 0.6 p, so one conditional
// subtract makes the result canonical.
__device__ __forceinline__ void mont_reduce_wide(uint32_t r[8], const uint32_t t[16]) {
  uint32_t a[8];
#pragma unroll
  for (int k = 0; k < 8; k++) a[k] = t[k];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t m = a[0] * FR_N0;
    uint32_t top = 0u, none = 0u;
    fr_mad_pairs(a, top, p_word(0), p_word(2), p_word(4), p_word(6), m);
    // word 0 is now zero: shift down one word
    uint32_t b[8] = {a[1], a[2], a[3], a[4], a[5], a[6], a[7], top};
    fr_mad_pairs(b, none, p_word(1), p_word(3), p_word(5), p_word(7), m);
    fr_copy(a, b);
  }
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
        "r"(a[6]), "r"(a[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]),
        "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]));
  fr_reduce_once(r, s, c);
}

// where lane L's quarter q of an element sits among its four (a swizzle that
// keeps both the quads' stores and the lanes' loads free of bank conflicts)
__device__ __forceinline__ int quarter_slot(int L, int q) { return q ^ ((L >> 1) & 3); }

__global__ void __launch_bounds__(MX_THREADS, 2)
rounds_mxu_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  const uint2* __restrict__ wfrag, int rounds, int64_t B) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint2* bfrag = reinterpret_cast<uint2*>(smem);  // [e][n-tile][k-step][lane]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  uint32_t* xs = smem + MX_FRAGS * 64 + warp * WARP_WORDS;  // X: lane rows
  uint32_t* vlo = xs + 32 * X_STRIDE;   // V: [lane][element][slot][4 words]
  uint32_t* vhi = vlo + 32 * VLO_STRIDE;  // V's top words: [lane][element][q]
  for (int k = threadIdx.x; k < MX_FRAGS * 32; k += MX_THREADS) bfrag[k] = wfrag[k];
  __syncthreads();  // the one block barrier, before the rounds

  const int64_t b = (int64_t)blockIdx.x * MX_THREADS + threadIdx.x;
  const bool live = b < B;  // the ragged tail computes on zeros, stores nothing
  uint32_t s[T3][8];
#pragma unroll
  for (int e = 0; e < T3; e++) {
    if (live) {
      load_elem(s[e], in, e, b, B);
    } else {
      fr_zero(s[e]);
    }
  }
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
    uint32_t* xrow = xs + lane * X_STRIDE;
#pragma unroll
    for (int e = 0; e < T3; e++) {
      ark_pow5(s[e], r, e);
      reinterpret_cast<uint4*>(xrow + 8 * e)[0] = make_uint4(s[e][0], s[e][1], s[e][2], s[e][3]);
      reinterpret_cast<uint4*>(xrow + 8 * e)[1] = make_uint4(s[e][4], s[e][5], s[e][6], s[e][7]);
    }
    __syncwarp();
#pragma unroll 1
    for (int mt = 0; mt < 2; mt++) {
      // A fragments of lanes 16 mt + g and + 8: words c and c + 4 of each element
      const uint32_t* x0 = xs + (16 * mt + g) * X_STRIDE + c;
      const uint32_t* x1 = x0 + 8 * X_STRIDE;
      uint32_t a[T3][4];
#pragma unroll
      for (int j = 0; j < T3; j++) {
        a[j][0] = x0[8 * j];
        a[j][1] = x1[8 * j];
        a[j][2] = x0[8 * j + 4];
        a[j][3] = x1[8 * j + 4];
      }
#pragma unroll
      for (int e = 0; e < T3; e++) {
        uint32_t lo[2][4], hi[2][4];
#pragma unroll
        for (int u = 0; u < 4; u++) {
          int32_t d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
          for (int h = 0; h < 2; h++)
#pragma unroll
            for (int j = 0; j < T3; j++)
              mma_m16n8k32_u8(d[h], a[j], bfrag[((e * 8 + 2 * u + h) * T3 + j) * 32 + lane]);
          // bytes 16c + 4u .. 16c + 4u + 3 of T_e, rows g and g + 8
          fold_word(lo[0][u], hi[0][u], d[0][0], d[0][1], d[1][0], d[1][1]);
          fold_word(lo[1][u], hi[1][u], d[0][2], d[0][3], d[1][2], d[1][3]);
        }
#pragma unroll
        for (int row = 0; row < 2; row++) {
          const int L = 16 * mt + 8 * row + g;
          uint32_t v[5];
          quarter_words(v, lo[row], hi[row]);
          *reinterpret_cast<uint4*>(vlo + L * VLO_STRIDE + 16 * e + 4 * quarter_slot(L, c)) =
              make_uint4(v[0], v[1], v[2], v[3]);
          vhi[L * VHI_STRIDE + 4 * e + c] = v[4];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < T3; e++) {
      uint32_t t[16];
#pragma unroll
      for (int q = 0; q < 4; q++) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            vlo + lane * VLO_STRIDE + 16 * e + 4 * quarter_slot(lane, q));
        t[4 * q] = w.x;
        t[4 * q + 1] = w.y;
        t[4 * q + 2] = w.z;
        t[4 * q + 3] = w.w;
      }
      const uint4 h = *reinterpret_cast<const uint4*>(vhi + lane * VHI_STRIDE + 4 * e);
      join_quarters(t, h.x, h.y, h.z);
      mont_reduce_wide(s[e], t);
    }
  }
#pragma unroll
  for (int e = 0; e < T3; e++)
    if (live) store_elem(out, s[e], e, b, B);
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

extern "C" int ctpu_rounds_mxu(const int64_t* in, int64_t* out, const uint32_t* wfrag,
                               int rounds, int64_t B, void* stream) {
  if (B <= 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rounds_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + MX_THREADS - 1) / MX_THREADS));
  rounds_mxu_kernel<<<grid, MX_THREADS, MX_SMEM, (cudaStream_t)stream>>>(
      in, out, reinterpret_cast<const uint2*>(wfrag), rounds, B);
  return (int)cudaGetLastError();
}

// The handles of this file's kernels (funcs.cuh).
extern "C" int ctpu_rounds_funcs(void** out) {
  const void* k[] = {(const void*)rounds_vpu_kernel,
                     (const void*)rounds_mxu_kernel};
  return kernel_funcs(k, 2, out);
}
