// Fused per-neighbor shading trunk, forward, with bfloat16 product
// operands (Hopper, mma.sync bf16 on the tensor cores).
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_fwd_kernel (:168) with
// bf16=True (dot=_dot_bf16, :176), launched by _fused_fwd_impl (pallas_call
// :364) under --trunk_dtype bfloat16. It computes K1's function
// (csrc/trunk_fwd.cu) with JAX's rounding sites: every MLP product (block1,
// block3 and the alpha head) takes operands rounded to bfloat16 and sums
// in fp32; the PE sine arguments, bias, LeakyReLU, the density activation
// and the weighted K-sum stay fp32:
//   x  = [emb, PE(emb), PE(d)]
//   h  = block1(x),  g = block3([h, ex3]),  a = act(g·wa + ba) (order 2)
//   feat[p] = Σ_k w·g,  alpha[p] = Σ_k w·a.
//
// What bounds it: the same ≈271k multiply-adds a row as K1 at lego widths,
// now one bf16 tensor-core product each (989 TFLOP/s dense) instead of
// K1's three TF32 ones (495 TFLOP/s): a sixth of K1's operations bound.
//
// Design: K1's tile (csrc/trunk_fwd.cuh) with bf16::tile_gemm
// (csrc/bf16_mma.cuh) for its products: one 256-thread block per 64-row
// tile, 8 warps in a 2 x 4 grid over m16n8k16 tiles, every layer in place
// on one fp32 [64, ld] shared buffer (ld ≡ 8 mod 32), the activations
// rounded to bf16 in registers as their fragments load. The weights are
// rounded once per launch (convert_weights) into one plane of bf16 pairs,
// padded to multiples of 16, where K1 splits them into TF32 hi and lo
// planes; they stream through shared memory in 32-row chunks,
// double-buffered with cp.async. The alpha head's warp-wide dot product
// rounds both operands. Nothing here is tuned yet: wgmma and TMA would
// take the products to the bf16 rate.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "trunk_pe.cuh"

namespace {

constexpr int TILE = 64;      // rows per block (multiple of every supported K)
constexpr int THREADS = bf16::GEMM_THREADS;   // 8 warps
constexpr int RPW = TILE / (THREADS / 32);    // rows per warp in the epilogues
constexpr int NT = 8;         // n-tiles per warp: 4 x 8 x 8 = 256 columns a pass
constexpr int KC = 32;        // weight rows per staged chunk
constexpr int MIN_BLOCKS = 2; // blocks an SM holds (≈110 KB of shared memory each)

struct Params {
  const float *emb, *d, *ex3, *w;
  bf16::Mat m1, m12, m3, m32;         // rounded w1 [C1, H1], w12, w3 [H1 + E3, H3], w32
  const float *b1, *b12, *b3, *b32;
  const float *wa, *ba;               // [H3], [1]
  float *feat, *alpha;                // [S/K, H3], [S/K]
  int S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, ld;                         // first-layer width, smem row stride
};

// Floats of the workspace the rounded weights take.
inline size_t workspace_floats(int C1, int H1, int E3, int H3, int L1,
                               int L3) {
  return bf16::convert_words(C1, H1)
       + (L1 == 2 ? bf16::convert_words(H1, H1) : 0)
       + bf16::convert_words(H1 + E3, H3)
       + (L3 == 2 ? bf16::convert_words(H3, H3) : 0);
}

// Fills p.C1 and p.ld; returns the bytes of shared memory the kernel uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.dd;
  int w = bf16::round16(p.C1);
  if (bf16::round16(p.H1 + p.E3) > w) w = bf16::round16(p.H1 + p.E3);
  if (bf16::round16(p.H3) > w) w = bf16::round16(p.H3);
  p.ld = tf32::stride_mod32(w, 8);
  return (size_t)(TILE * p.ld + bf16::ws_words(NT, KC) + 2 * TILE) *
         sizeof(float);
}

struct Smem {
  float* buf;        // [TILE, ld] activations, every layer in place
  uint32_t* ws;      // 2 stages of weight chunks
  float *wrow, *arow;   // [TILE] neighbor weights, activated alphas
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.buf = smem;
  s.ws = reinterpret_cast<uint32_t*>(s.buf + TILE * p.ld);
  s.wrow = reinterpret_cast<float*>(s.ws + bf16::ws_words(NT, KC));
  s.arow = s.wrow + TILE;
  return s;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.1f * x; }

// buf[r, n] = leaky(Σ_k bf16(buf[r, k])·W[k, n] + b[n]) for the block's 64
// rows and n < W.np (zero for n >= H), in place.
__device__ __forceinline__ void dense(float* buf, const bf16::Mat& W,
                                      const float* __restrict__ b, int H,
                                      int ld, uint32_t* ws) {
  bf16::tile_gemm<TILE, NT, KC>(
      buf, ld, W, ws, [&](int r, int n, float v0, float v1) {
        float2 o;
        o.x = n < H ? leaky(v0 + __ldg(b + n)) : 0.f;
        o.y = n + 1 < H ? leaky(v1 + __ldg(b + n + 1)) : 0.f;
        *reinterpret_cast<float2*>(buf + r * ld + n) = o;
      });
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
trunk_fwd_bf16_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  const int row0 = blockIdx.x * TILE;
  if (threadIdx.x < TILE) {
    const int g = row0 + threadIdx.x;
    s.wrow[threadIdx.x] = g < p.S ? p.w[g] : 0.f;
  }
  // first-layer input [emb, PE(emb), PE(d)]; rows past S and the padding
  // columns up to the product's depth are zero
  float* cur = s.buf;
  pe::build_x0<TILE, THREADS>(p.emb, p.Fe, p.d + (size_t)row0 * p.dd, p.dd,
                              p.nf, p.nd, row0, p.S, p.C1, p.m1.kp, cur,
                              p.ld);
  __syncthreads();
  dense(cur, p.m1, p.b1, p.H1, p.ld, s.ws);
  if (p.L1 == 2) dense(cur, p.m12, p.b12, p.H1, p.ld, s.ws);
  // block3's input row [h, ex3], zero-padded to the product's depth
  const float* ex3 = p.ex3 + (size_t)row0 * p.E3;
  const int e3p = p.m3.kp - p.H1;
  for (int idx = threadIdx.x; idx < TILE * e3p; idx += THREADS) {
    const int r = idx / e3p, c = idx - r * e3p, g = row0 + r;
    cur[r * p.ld + p.H1 + c] = g < p.S && c < p.E3 ? ex3[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  dense(cur, p.m3, p.b3, p.H3, p.ld, s.ws);
  if (p.L3 == 2) dense(cur, p.m32, p.b32, p.H3, p.ld, s.ws);

  if (!p.order1) {
    // alpha head per row: warp-wide dot product of bf16-rounded operands
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float sum = 0.f;
      for (int k = lane; k < p.H3; k += 32)
        sum = fmaf(bf16::rn(cur[r * p.ld + k]), bf16::rn(__ldg(p.wa + k)), sum);
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

// Floats of the workspace trunk_fwd_bf16 takes for the rounded weights.
extern "C" long long trunk_fwd_bf16_workspace(int C1, int H1, int E3, int H3,
                                              int L1, int L3) {
  return (long long)workspace_floats(C1, H1, E3, H3, L1, L3);
}

// Rounds the weights into ws (ws_floats floats, trunk_fwd_bf16_workspace's
// count), then runs the trunk; the arguments are trunk_fwd's. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int trunk_fwd_bf16(const float* emb, const float* d,
                              const float* ex3, const float* w,
                              const float* w1, const float* b1,
                              const float* w12, const float* b12,
                              const float* w3, const float* b3,
                              const float* w32, const float* b32,
                              const float* wa, const float* ba, float* feat,
                              float* alpha, float* ws, long long ws_floats,
                              int S, int Fe, int dd, int E3, int nf, int nd,
                              int H1, int H3, int L1, int L3, int K,
                              int act_super, int order1, void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w;
  p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32; p.wa = wa; p.ba = ba;
  p.feat = feat; p.alpha = alpha;
  p.S = S; p.Fe = Fe; p.dd = dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const size_t smem = setup(p);
  if ((long long)workspace_floats(p.C1, H1, E3, H3, L1, L3) > ws_floats ||
      bf16::round16(H1) > 32 * NT || bf16::round16(H3) > 32 * NT)
    return (int)cudaErrorInvalidValue;
  bf16::ConvertJob job{};
  p.m1 = bf16::add_convert(job, w1, p.C1, H1, false, ws);
  if (L1 == 2) p.m12 = bf16::add_convert(job, w12, H1, H1, false, ws);
  p.m3 = bf16::add_convert(job, w3, H1 + E3, H3, false, ws);
  if (L3 == 2) p.m32 = bf16::add_convert(job, w32, H3, H3, false, ws);
  cudaFuncSetAttribute(trunk_fwd_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (S + TILE - 1) / TILE;
  if (blocks <= 0) return (int)cudaGetLastError();
  const cudaError_t err = bf16::launch_convert(job, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  trunk_fwd_bf16_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
