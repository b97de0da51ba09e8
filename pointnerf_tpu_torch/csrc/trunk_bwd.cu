// Fused per-neighbor shading trunk, backward (Hopper, fp32).
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_bwd_kernel (:191), launched
// by _fused_bwd_rule (:387, pallas_call :412). Per neighbor row it recomputes
// the forward of csrc/trunk_fwd.cu,
//   x0 = [emb, PE(emb), PE(d)],  h = block1(x0),  g = block3([h, ex3]),
//   za = g·wa + ba (order 2),
// then chains the per-shading-point cotangents back: dfeat and dalpha are
// un-grouped to the K rows of each point, and
//   dw  = g·dfeat + act(za)·dalpha
//   dza = dalpha·w·act'(za),  dg = dfeat·w + dza·waᵀ
// go back through block3 and block1 (LeakyReLU(0.1) gates read off the sign
// of each layer's output) to demb, dd (through the PE sines), dex3, and the
// gradient of every weight and bias.
//
// What bounds it: about 3x the forward's 271k multiply-adds per row at lego
// widths (recompute, dx = dz·Wᵀ, dW = xᵀ·dz), fp32 FMA issue as in K1, plus
// the read-modify-write of each block's private dW partial (1.1 MB) once
// per tile, which at 32-row tiles costs about 12 multiply-adds per byte.
// On an H100 80GB HBM3 at 700 W the wide train-step tier (96,000 rows)
// took 11.7 ms, ≈13 TFLOP/s, when the 264- and 284-column products of
// dz·Wᵀ still ran two 256-column passes: ≈2.4 ms recompute, ≈4 ms dz·Wᵀ,
// ≈3.6 ms dW.
//
// Design (a simple first version). Nothing from the forward pass is kept:
// one 256-thread block takes a 32-row tile and recomputes it. The backward
// needs every layer's output of the tile at once (x0 is rebuilt instead),
// so four [32, ld] activation buffers live in shared memory (145 KB at
// lego widths, 182 KB with the weight chunks) and each cotangent overwrites
// the activation whose sign gates it; at K1's 64 rows they would not fit
// in 227 KB. Weights stream through shared memory in 16-row chunks with
// double-buffered cp.async as in K1; the wrapper passes each weight
// transposed as well, so dz·Wᵀ runs the same row-major product as the
// forward, in one pass of up to 288 columns. Each
// block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its
// own dW partial in global memory (written at its first tile, added to
// after); a second kernel sums the partials in block order. No float
// atomics, so two runs on one device give bit-identical gradients.
// Every product is fp32 FMA in this file; PE uses full-precision sinf/cosf.
// The tile code lives in trunk_bwd.cuh, which K5 (shade_bwd.cu) shares.

#include "trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
trunk_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  float* part = p.partial + (size_t)blockIdx.x * p.nW;
  const int ntiles = (p.S + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    if (threadIdx.x < TILE) {
      const int g = row0 + threadIdx.x;
      s.wrow[threadIdx.x] = g < p.S ? p.w[g] : 0.f;
    }
    const Tile t{p.d + (size_t)row0 * p.Dd, p.ex3 + (size_t)row0 * p.E3,
                 p.dd + (size_t)row0 * p.Dd, p.dex3 + (size_t)row0 * p.E3,
                 p.dw + row0};
    trunk_bwd_tile(p, row0, tile == blockIdx.x, t, s, part);
  }
}

}  // namespace

// dweights receives every layer's gradient, flat, in the order
// w1 [C1,H1], b1, (w12 [H1,H1], b12), w3 [H1+E3,H3], b3, (w32, b32),
// (wa [H3], ba); partial holds n_ctas such sets. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int trunk_bwd(const float* emb, const float* d, const float* ex3,
                         const float* w, const float* dfeat,
                         const float* dalpha, const float* w1, const float* b1,
                         const float* w12, const float* b12, const float* w3,
                         const float* b3, const float* w32, const float* b32,
                         const float* wa, const float* ba, const float* w1t,
                         const float* w12t, const float* w3t, const float* w32t,
                         float* demb, float* dd, float* dex3, float* dw,
                         float* partial, float* dweights, int S, int Fe,
                         int Dd, int E3, int nf, int nd, int H1, int H3,
                         int L1, int L3, int K, int act_super, int order1,
                         int n_ctas, void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w; p.dfeat = dfeat;
  p.dalpha = dalpha; p.w1 = w1; p.b1 = b1; p.w12 = w12; p.b12 = b12;
  p.w3 = w3; p.b3 = b3; p.w32 = w32; p.b32 = b32; p.wa = wa; p.ba = ba;
  p.w1t = w1t; p.w12t = w12t; p.w3t = w3t; p.w32t = w32t;
  p.demb = demb; p.dd = dd; p.dex3 = dex3; p.dw = dw; p.partial = partial;
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const size_t smem = setup(p);
  cudaFuncSetAttribute(trunk_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (S <= 0 || n_ctas <= 0) return (int)cudaGetLastError();
  trunk_bwd_kernel<<<n_ctas, THREADS, smem, (cudaStream_t)stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(p.nW + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, n_ctas, p.nW, dweights);
  return (int)cudaGetLastError();
}
