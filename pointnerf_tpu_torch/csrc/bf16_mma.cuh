// Tensor-core products with bfloat16 operands for the trunk's bfloat16
// kernels (csrc/trunk_fwd_bf16.cu, csrc/trunk_bwd_bf16.cu), on
// mma.sync.aligned.m16n8k16 bf16 with fp32 accumulators.
//
// Each operand is rounded to bfloat16 (cvt.rn: nearest, ties to even, as
// jnp.astype(bfloat16)); the product of two bfloat16 values is exact in
// fp32 and the products sum in fp32: the function of the JAX package's
// _dot_bf16 (pointnerf_tpu/ops/pallas_trunk.py:112). Weights are rounded
// once per launch (convert_weights, into a workspace the wrapper
// allocates) into one plane of bf16 pairs; activations stay fp32 in shared
// memory and are rounded in registers as their fragments are loaded.
//
// Fragment layouts of m16n8k16 .bf16 (PTX ISA), g = lane / 4, t = lane % 4;
// a 32-bit register holds two bf16, the lower-indexed one in its low half:
//   A (16 x 16, 4 regs): a0 (g, 2t..2t+1),  a1 (g + 8, 2t..2t+1),
//                        a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, 2 regs):  b0 (2t..2t+1, g),  b1 (2t+8..2t+9, g)
//   C (16 x 8, 4 f32):   c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"   // cp.async helpers, round8, stride_mod32

namespace bf16 {

// {bf16(lo) in the low half, bf16(hi) in the high half}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bfloat16, as an fp32 value
__device__ __forceinline__ float rn(float x) {
  return __uint_as_float(pack(x, 0.f) << 16);
}

// c += a·b, one m16n8k16 bf16 product
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// A weight matrix as the products read it: B[k, n] for k < kp, n < np
// (both multiples of 16, zero past the real rows and columns), as bf16
// pairs along k: word (k / 2)·np + n holds B[2·(k / 2), n] in its low half
// and B[2·(k / 2) + 1, n] in its high half.
struct Mat {
  const uint32_t* w;
  int kp, np;
};

// Weights to round: B[k, n] = src[k, n] (or src[n, k] when transposed) of
// a row-major [rows, cols] src.
constexpr int MAX_CONVERT = 8;
struct ConvertJob {
  const float* src[MAX_CONVERT];
  uint32_t* dst[MAX_CONVERT];
  int rows[MAX_CONVERT], cols[MAX_CONVERT], trans[MAX_CONVERT],
      kp[MAX_CONVERT], np[MAX_CONVERT];
  int n;
};

__global__ void convert_weights(ConvertJob job) {
  for (int m = 0; m < job.n; ++m) {
    const int np = job.np[m], cols = job.cols[m];
    const int K = job.trans[m] ? cols : job.rows[m];
    const int N = job.trans[m] ? job.rows[m] : cols;
    const float* src = job.src[m];
    auto at = [&](int k, int n) {
      if (k >= K || n >= N) return 0.f;
      return job.trans[m] ? src[(size_t)n * cols + k]
                          : src[(size_t)k * cols + n];
    };
    const int words = job.kp[m] / 2 * np;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < words;
         i += gridDim.x * blockDim.x) {
      const int kk = i / np, n = i - kk * np;
      job.dst[m][i] = pack(at(2 * kk, n), at(2 * kk + 1, n));
    }
  }
}

// 32-bit words of a converted [K, N] product operand (K the depth).
inline size_t convert_words(int K, int N) {
  return (size_t)round16(K) / 2 * round16(N);
}

// Adds the rounding of src [rows, cols] (transposed if trans) to job, its
// plane carved from *ws (16-byte aligned); returns the Mat the products
// read.
inline Mat add_convert(ConvertJob& job, const float* src, int rows, int cols,
                       bool trans, float*& ws) {
  Mat m;
  m.kp = round16(trans ? cols : rows);
  m.np = round16(trans ? rows : cols);
  const int i = job.n++;
  job.src[i] = src;
  job.dst[i] = reinterpret_cast<uint32_t*>(ws);
  job.rows[i] = rows;
  job.cols[i] = cols;
  job.trans[i] = trans;
  job.kp[i] = m.kp;
  job.np[i] = m.np;
  m.w = job.dst[i];
  ws += convert_words(m.kp, m.np);
  return m;
}

inline cudaError_t launch_convert(const ConvertJob& job, cudaStream_t stream) {
  if (job.n > 0) convert_weights<<<264, 256, 0, stream>>>(job);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tile GEMM
// out[r, n] = epi(Σ_k bf16(in[r, k])·B[k, n]) for the tile's ROWS rows and
// all n < B.np <= 32·NT (one pass), with `in` a row-major fp32 [ROWS, ld]
// buffer in shared memory (columns [0, B.kp) finite; ld ≡ 8 mod 32, so the
// 8-byte A loads of a half-warp are conflict-free) and B streamed through
// `ws` in KC-row chunks (KC a multiple of 16), double-buffered with
// cp.async. 8 warps in a 2 x 4 grid: warp (wm, wn) owns rows wm·ROWS/2 ..
// and the n-tiles wn, wn + 4, ... (NT of them). `ws` holds ws_words(NT,
// KC) words. Every thread must call it; it ends with a barrier. `in` may
// be the buffer the epilogue writes: the products have read it by then.
// The epilogue is called as epi(r, n, v0, v1) for the values of columns n
// and n + 1 of row r, for every row r < ROWS and even column n < B.np.
constexpr int GEMM_THREADS = 256;

__host__ __device__ constexpr int ws_words(int NT, int KC) {
  return 2 * (KC / 2) * tf32::stride_mod32(32 * NT, 8);
}

template <int ROWS, int NT, int KC, class Epi>
__device__ void tile_gemm(const float* in, int ld, const Mat& B, uint32_t* ws,
                          Epi epi) {
  constexpr int MT = ROWS / 32;           // m-tiles of 16 rows per warp
  static_assert(MT >= 1 && ROWS % 32 == 0, "ROWS must be a multiple of 32");
  static_assert(KC % 16 == 0, "KC must be a multiple of 16");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int rbase = wm * (ROWS / 2);
  const int nchunks = (B.kp + KC - 1) / KC;
  const int hs = tf32::stride_mod32(B.np, 8);   // words a staged pair-row
  bool live[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) live[j] = wn + 4 * j < (B.np >> 3);
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // pair-rows [k0 / 2, (k0 + kn) / 2) of B into dst, as one commit group
  auto stage = [&](int k0, int kn, uint32_t* dst) {
    const int q = B.np >> 2;
    for (int i = threadIdx.x; i < (kn >> 1) * q; i += GEMM_THREADS) {
      const int r = i / q, c4 = (i - r * q) * 4;
      tf32::cp16(reinterpret_cast<float*>(dst + r * hs + c4),
                 reinterpret_cast<const float*>(
                     B.w + (size_t)((k0 >> 1) + r) * B.np + c4));
    }
    tf32::commit();
  };
  stage(0, min(KC, B.kp), ws);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * KC, kn = min(KC, B.kp - k0);
    if (ch + 1 < nchunks) {
      stage(k0 + KC, min(KC, B.kp - k0 - KC), ws + ((ch + 1) & 1) * (KC / 2) * hs);
      tf32::wait<1>();
    } else {
      tf32::wait<0>();
    }
    __syncthreads();
    const uint32_t* bw = ws + (ch & 1) * (KC / 2) * hs;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      if (ks < kn) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* p = in + (rbase + 16 * i + g) * ld + k0 + ks + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(p);
          const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
          const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
          a[i][0] = pack(x0.x, x0.y);
          a[i][1] = pack(x1.x, x1.y);
          a[i][2] = pack(x2.x, x2.y);
          a[i][3] = pack(x3.x, x3.y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (live[j]) {
            const int o = ((ks >> 1) + t) * hs + 8 * (wn + 4 * j) + g;
            const uint32_t b0 = bw[o], b1 = bw[o + 4 * hs];
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(acc[i][j], a[i], b0, b1);
          }
        }
      }
    }
    __syncthreads();   // chunk ch's buffer is refilled two chunks later
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (live[j]) {
      const int n = 8 * (wn + 4 * j) + 2 * t;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = rbase + 16 * i + g;
        epi(r, n, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, n, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  __syncthreads();   // the epilogue's writes before anyone reads them
}

}  // namespace bf16
