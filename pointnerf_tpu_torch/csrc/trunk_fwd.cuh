// The fused trunk's forward on one 64-row tile, shared by csrc/trunk_fwd.cu
// (K1, whose header comment gives the design) and csrc/shade_fwd.cu (K4,
// which computes the tile's inputs in the kernel first).
//
// Per neighbor row r of the tile:
//   x  = [emb, PE(emb), PE(d)]           PE column order channel → freq → (sin, cos)
//   h  = block1(x)                       1-2 LeakyReLU(0.1) layers
//   g  = block3([h, ex3])                1-2 LeakyReLU(0.1) layers
//   a  = softplus(g·wa + ba − 1)         (relu without act_super; order 2 only)
// then per shading point, feat[p] = Σ_k w·g and alpha[p] = Σ_k w·a.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"
#include "trunk_pe.cuh"

namespace {

constexpr int TILE = 64;      // rows per block (multiple of every supported K)
constexpr int THREADS = tf32::GEMM_THREADS;   // 8 warps
constexpr int RPW = TILE / (THREADS / 32);    // rows per warp in the epilogues
constexpr int NT = 8;         // n-tiles per warp: 4 x 8 x 8 = 256 columns a pass
constexpr int KC = 8;         // weight rows per staged chunk
constexpr int MIN_BLOCKS = 2; // blocks an SM holds (109 KB of shared memory
                              // and <= 128 registers a thread each): two
                              // hide each other's barriers, PE, epilogues

struct Params {
  const float *emb, *d, *ex3, *w;     // d, ex3, w: K1's row inputs
  tf32::Mat m1, m12, m3, m32;         // split w1 [C1, H1] = [w1e; w1p; w1d],
                                      // w12, w3 [H1 + E3, H3] = [w3x; w3e], w32
  const float *b1, *b12, *b3, *b32;
  const float *wa, *ba;               // [H3], [1]
  float *feat, *alpha;                // [S/K, H3], [S/K]
  int S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, ld;                         // first-layer width, smem row stride
};

// Floats of the workspace the split weights take (the wrapper allocates
// it; trunk_fwd_workspace exports it).
inline size_t fwd_workspace_floats(int C1, int H1, int E3, int H3, int L1,
                                   int L3) {
  return tf32::split_floats(C1, H1) + (L1 == 2 ? tf32::split_floats(H1, H1) : 0)
       + tf32::split_floats(H1 + E3, H3)
       + (L3 == 2 ? tf32::split_floats(H3, H3) : 0);
}

// Fills p.C1 and p.ld; returns the bytes of shared memory trunk_tile uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.dd;
  int w = tf32::round8(p.C1);
  if (tf32::round8(p.H1 + p.E3) > w) w = tf32::round8(p.H1 + p.E3);
  if (tf32::round8(p.H3) > w) w = tf32::round8(p.H3);
  p.ld = tf32::stride_mod32(w, 4);   // conflict-free A fragments
  return (size_t)(TILE * p.ld + tf32::ws_floats(NT, KC) + 2 * TILE) *
         sizeof(float);
}

// Splits the weights into `ws` (ws_floats of them) and points p's Mats at
// them; returns the split job for tf32::launch_split, n = -1 when the
// workspace is too small or a layer wider than one pass of the products.
inline tf32::SplitJob split_job(Params& p, const float* w1, const float* w12,
                                const float* w3, const float* w32, float* ws,
                                size_t ws_floats) {
  tf32::SplitJob job{};
  if (fwd_workspace_floats(p.C1, p.H1, p.E3, p.H3, p.L1, p.L3) > ws_floats ||
      tf32::round8(p.H1) > 32 * NT || tf32::round8(p.H3) > 32 * NT) {
    job.n = -1;
    return job;
  }
  p.m1 = tf32::add_split(job, w1, p.C1, p.H1, false, ws);
  if (p.L1 == 2) p.m12 = tf32::add_split(job, w12, p.H1, p.H1, false, ws);
  p.m3 = tf32::add_split(job, w3, p.H1 + p.E3, p.H3, false, ws);
  if (p.L3 == 2) p.m32 = tf32::add_split(job, w32, p.H3, p.H3, false, ws);
  return job;
}

// The tile's shared memory: one activation buffer (every layer runs in
// place), the weight chunks, the rows' neighbor weights and activated
// alphas. A kernel's own shared arrays start at `end`.
struct Smem {
  float *buf, *ws, *wrow, *arow, *end;
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.buf = smem;
  s.ws = s.buf + TILE * p.ld;       // 2 stages x (hi, lo) weight chunks
  s.wrow = s.ws + tf32::ws_floats(NT, KC);   // [TILE] neighbor weights
  s.arow = s.wrow + TILE;           // [TILE] activated alpha per row
  s.end = s.arow + TILE;
  return s;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.1f * x; }

// buf[r, n] = leaky(Σ_k buf[r, k] W[k, n] + b[n]) for the block's 64 rows
// and n < W.np (zero for n >= H), in place: the products (tensor cores,
// 3xTF32, tf32::tile_gemm, one pass as H <= 256) read buf before the
// epilogue writes it.
__device__ __forceinline__ void dense(float* buf, const tf32::Mat& W,
                                      const float* __restrict__ b, int H,
                                      int ld, float* ws) {
  tf32::tile_gemm<TILE, NT, KC, false>(
      buf, ld, W, ws, [&](int r, int n, float v0, float v1) {
        float2 o;
        o.x = n < H ? leaky(v0 + __ldg(b + n)) : 0.f;
        o.y = n + 1 < H ? leaky(v1 + __ldg(b + n + 1)) : 0.f;
        *reinterpret_cast<float2*>(buf + r * ld + n) = o;
      });
}

// The trunk of the tile whose first row is row0. Row r of the tile reads
// its distances at d_t[r·dd] and its ex3 at ex3_t[r·E3] (global or shared
// memory; read for rows < S only) and its neighbor weight at s.wrow[r],
// which the caller writes before the call (0 past S). Writes feat and
// alpha of the tile's shading points.
__device__ __forceinline__ void trunk_tile(const Params& p, int row0,
                                           const float* d_t,
                                           const float* ex3_t,
                                           const Smem& s) {
  // first-layer input [emb, PE(emb), PE(d)]; rows past S and the padding
  // columns up to the product's depth are zero
  float* cur = s.buf;
  pe::build_x0<TILE, THREADS>(p.emb, p.Fe, d_t, p.dd, p.nf, p.nd, row0, p.S,
                              p.C1, p.m1.kp, cur, p.ld);
  __syncthreads();
  dense(cur, p.m1, p.b1, p.H1, p.ld, s.ws);
  if (p.L1 == 2) dense(cur, p.m12, p.b12, p.H1, p.ld, s.ws);
  // park ex3 beside h: block3's input row is [h, ex3], zero-padded to the
  // product's depth
  const int e3p = p.m3.kp - p.H1;
  for (int idx = threadIdx.x; idx < TILE * e3p; idx += THREADS) {
    const int r = idx / e3p, c = idx - r * e3p, g = row0 + r;
    cur[r * p.ld + p.H1 + c] =
        g < p.S && c < p.E3 ? ex3_t[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  dense(cur, p.m3, p.b3, p.H3, p.ld, s.ws);
  if (p.L3 == 2) dense(cur, p.m32, p.b32, p.H3, p.ld, s.ws);

  if (!p.order1) {
    // alpha head per row: warp-wide dot product, then the density activation
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float sum = 0.f;
      for (int k = lane; k < p.H3; k += 32) sum = fmaf(cur[r * p.ld + k], __ldg(p.wa + k), sum);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float za = sum + __ldg(p.ba);
        s.arow[r] = p.act_super ? fmaxf(za - 1.f, 0.f) + log1pf(expf(-fabsf(za - 1.f)))
                                : fmaxf(za, 0.f);
      }
    }
    __syncthreads();
  }

  // weighted K-sum per shading point; a point exists iff its first row < S
  const int npts = TILE / p.K;
  const int pt0 = row0 / p.K;
  for (int idx = threadIdx.x; idx < npts * p.H3; idx += THREADS) {
    const int q = idx / p.H3, c = idx - q * p.H3;
    if (row0 + q * p.K >= p.S) continue;
    float sum = 0.f;
    for (int k = 0; k < p.K; ++k) {
      const int r = q * p.K + k;
      sum = fmaf(s.wrow[r], cur[r * p.ld + c], sum);
    }
    p.feat[(size_t)(pt0 + q) * p.H3 + c] = sum;
  }
  if (!p.order1 && threadIdx.x < npts && row0 + threadIdx.x * p.K < p.S) {
    const int q = threadIdx.x;
    float sum = 0.f;
    for (int k = 0; k < p.K; ++k) sum = fmaf(s.wrow[q * p.K + k], s.arow[q * p.K + k], sum);
    p.alpha[pt0 + q] = sum;
  }
}

}  // namespace
