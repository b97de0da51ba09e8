// Tensor-core products in 3xTF32 for the trunk kernels (csrc/trunk_fwd.cuh,
// csrc/trunk_bwd.cuh), on mma.sync.aligned.m16n8k8 TF32 with fp32
// accumulators.
//
// 3xTF32: an fp32 value a is split into a_hi = tf32(a) and a_lo = tf32(a −
// a_hi) (cvt.rna.tf32.f32: round to nearest, ties away, 10 mantissa bits),
// and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, accumulated in fp32. The
// dropped a_lo·b_lo term is about 2^-22 of a·b, so the products keep
// fp32-level error at a third of the TF32 rate. Weights are split once per
// launch (split_weights, into a workspace the wrapper allocates) and staged
// into shared memory as hi and lo planes; activations are split in
// registers as their fragments are loaded.
//
// Fragment layouts of m16n8k8 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16 x 8, 4 regs): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, 2 regs):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8, 4 f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Each fragment is loaded from shared memory by index arithmetic, so any
// layout serves: a row stride ≡ 4 (mod 32) floats makes the A loads of a
// row-major [rows, k] buffer conflict-free, a stride ≡ 8 (mod 32) the B
// loads of a row-major [k, n] buffer and the A loads of a [k, m] one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// c += a·b, one m16n8k8 TF32 product (not volatile: the compiler may
// interleave independent products to hide their latency)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 products of one k-step of a warp: MT m-tiles of A (hi, lo)
// against the G n-tiles j0 .. j0 + G of B with live[j] (hi b[j - j0][0..1],
// lo b[j - j0][2..3]). The three passes run over all these tiles in turn,
// the small cross terms first, so consecutive products go to different
// accumulators; with SEP the small terms go to accumulators of their own
// (`accs`, summed into acc at the end), so the big terms' accumulation does
// not round them away.
template <int MT, int NT, int G, bool SEP>
__device__ __forceinline__ void mma3_group(float (&acc)[MT][NT][4],
                                           float (&accs)[MT][NT][4],
                                           const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4],
                                           const uint32_t (&b)[G][4],
                                           const bool (&live)[NT], int j0) {
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (live[j0 + q])
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma(SEP ? accs[i][j0 + q] : acc[i][j0 + q], al[i], b[q][0], b[q][1]);
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (live[j0 + q])
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma(SEP ? accs[i][j0 + q] : acc[i][j0 + q], ah[i], b[q][2], b[q][3]);
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (live[j0 + q])
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma(acc[i][j0 + q], ah[i], b[q][0], b[q][1]);
}

// 16-byte asynchronous copy global → shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int src_bytes = 16) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// the smallest stride >= n with stride ≡ r (mod 32)
__host__ __device__ constexpr int stride_mod32(int n, int r) {
  return n + ((r - n) % 32 + 32) % 32;
}

// A weight matrix as the products read it: B[k, n] for k < kp, n < np,
// row-major with row stride np, zero past the real rows and columns, as
// hi and lo TF32 planes.
struct Mat {
  const float *hi, *lo;
  int kp, np;
};

// Weights to split: dst[k, n] = src[k, n] (or src[n, k] when transposed)
// of a row-major [rows, cols] src, padded with zeros to [kp, np], kp and
// np the real extents rounded up to 8.
constexpr int MAX_SPLIT = 8;
struct SplitJob {
  const float* src[MAX_SPLIT];
  float* hi[MAX_SPLIT];
  int rows[MAX_SPLIT], cols[MAX_SPLIT], trans[MAX_SPLIT], kp[MAX_SPLIT],
      np[MAX_SPLIT];
  int n;
};

__global__ void split_weights(SplitJob job) {
  for (int m = 0; m < job.n; ++m) {
    const int kp = job.kp[m], np = job.np[m], cols = job.cols[m];
    const int K = job.trans[m] ? cols : job.rows[m];
    const int N = job.trans[m] ? job.rows[m] : cols;
    float* hi = job.hi[m];
    float* lo = hi + (size_t)kp * np;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kp * np;
         i += gridDim.x * blockDim.x) {
      const int k = i / np, n = i - k * np;
      float v = 0.f;
      if (k < K && n < N)
        v = job.trans[m] ? job.src[m][(size_t)n * cols + k]
                         : job.src[m][(size_t)k * cols + n];
      uint32_t h, l;
      split(v, h, l);
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    }
  }
}

// Adds the split of src [rows, cols] (transposed if trans) to job, its
// planes carved from *ws; returns the Mat the products read.
inline Mat add_split(SplitJob& job, const float* src, int rows, int cols,
                     bool trans, float*& ws) {
  Mat m;
  m.kp = round8(trans ? cols : rows);
  m.np = round8(trans ? rows : cols);
  const int i = job.n++;
  job.src[i] = src;
  job.hi[i] = ws;
  job.rows[i] = rows;
  job.cols[i] = cols;
  job.trans[i] = trans;
  job.kp[i] = m.kp;
  job.np[i] = m.np;
  m.hi = ws;
  m.lo = ws + (size_t)m.kp * m.np;
  ws += 2 * (size_t)m.kp * m.np;
  return m;
}

// Floats add_split carves for a [rows, cols] matrix (either orientation).
inline size_t split_floats(int rows, int cols) {
  return 2 * (size_t)round8(rows) * round8(cols);
}

inline cudaError_t launch_split(const SplitJob& job, cudaStream_t stream) {
  if (job.n > 0) split_weights<<<264, 256, 0, stream>>>(job);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tile GEMM
// out[r, n] = epi(Σ_k in[r, k] · B[k, n]) for the tile's ROWS rows and all
// n < B.np <= 32·NT (one pass; the callers check the widths), with `in` a
// row-major [ROWS, ld] buffer in shared memory (columns [0, B.kp) finite;
// ld ≡ 4 mod 32) and B streamed through `ws` in KC-row chunks, hi and lo
// planes, double-buffered with cp.async. 8 warps in a 2 x 4 grid: warp
// (wm, wn) owns rows wm·ROWS/2 .. and the n-tiles wn, wn + 4, ... (NT of
// them). `ws` holds ws_floats(NT, KC) floats. Every thread must call it;
// it ends with a barrier. `in` may be the buffer the epilogue writes: the
// products have read it by then. SEP keeps the small cross terms in
// accumulators of their own (mma3_group). The epilogue functor is called
// as epi(r, n, v0, v1) for the values of columns n and n + 1 of row r, for
// every row r < ROWS and even column n < B.np (B.np is a multiple of 8).
constexpr int GEMM_THREADS = 256;

__host__ __device__ constexpr int ws_floats(int NT, int KC) {
  return 2 * 2 * KC * stride_mod32(32 * NT, 8);
}

// rows [k0, k0 + kn) of both planes of B into dst (hi plane, then lo at
// + KC·hs), as one commit group
template <int KC>
__device__ __forceinline__ void stage_b(const Mat& B, int k0, int kn, int hs,
                                        float* dst) {
  const int q = B.np >> 2;
  for (int i = threadIdx.x; i < kn * q; i += GEMM_THREADS) {
    const int r = i / q, c4 = (i - r * q) * 4;
    const size_t src = (size_t)(k0 + r) * B.np + c4;
    cp16(dst + r * hs + c4, B.hi + src);
    cp16(dst + KC * hs + r * hs + c4, B.lo + src);
  }
  commit();
}

template <int ROWS, int NT, int KC, bool SEP, class Epi>
__device__ void tile_gemm(const float* in, int ld, const Mat& B, float* ws,
                          Epi epi) {
  constexpr int MT = ROWS / 32;           // m-tiles of 16 rows per warp
  static_assert(MT >= 1 && ROWS % 32 == 0, "ROWS must be a multiple of 32");
  constexpr int G = NT % 3 == 0 ? 3 : 4;  // n-tiles whose B fragments are
  static_assert(NT % G == 0, "NT must be a multiple of 3 or 4");  // held
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int rbase = wm * (ROWS / 2);
  const int nchunks = (B.kp + KC - 1) / KC;
  const int hs = stride_mod32(B.np, 8);
  bool live[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) live[j] = wn + 4 * j < (B.np >> 3);
  float acc[MT][NT][4], accs[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = accs[i][j][e] = 0.f;
  stage_b<KC>(B, 0, min(KC, B.kp), hs, ws);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * KC, kn = min(KC, B.kp - k0);
    if (ch + 1 < nchunks) {
      stage_b<KC>(B, k0 + KC, min(KC, B.kp - k0 - KC), hs,
                  ws + ((ch + 1) & 1) * 2 * KC * hs);
      wait<1>();
    } else {
      wait<0>();
    }
    __syncthreads();
    const float* bh = ws + (ch & 1) * 2 * KC * hs;
    const float* bl = bh + KC * hs;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      if (ks < kn) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* a = in + (rbase + 16 * i + g) * ld + k0 + ks + t;
          split(a[0], ah[i][0], al[i][0]);
          split(a[8 * ld], ah[i][1], al[i][1]);
          split(a[4], ah[i][2], al[i][2]);
          split(a[8 * ld + 4], ah[i][3], al[i][3]);
        }
        // B's fragments a group of G n-tiles at a time (fewer registers)
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += G) {
          uint32_t b[G][4];
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const int o = (ks + t) * hs + 8 * (wn + 4 * (j0 + q)) + g;
            if (live[j0 + q]) {
              b[q][0] = __float_as_uint(bh[o]);
              b[q][1] = __float_as_uint(bh[o + 4 * hs]);
              b[q][2] = __float_as_uint(bl[o]);
              b[q][3] = __float_as_uint(bl[o + 4 * hs]);
            }
          }
          mma3_group<MT, NT, G, SEP>(acc, accs, ah, al, b, live, j0);
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
        if (SEP)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += accs[i][j][e];
        epi(r, n, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, n, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  __syncthreads();   // the epilogue's writes before anyone reads them
}

}  // namespace tf32
