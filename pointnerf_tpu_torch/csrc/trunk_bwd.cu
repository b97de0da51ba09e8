// Fused per-neighbor shading trunk, backward (Hopper, fp32 in 3xTF32 on the
// tensor cores).
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
// What bounds it: about 3x the forward's 271k multiply-adds per row at
// lego widths (recompute, dx = dz·Wᵀ, dW = xᵀ·dz), in 3xTF32 on the
// tensor cores, plus the bytes of the scratch between the two phases
// (≈2,080 floats a row as hi and lo planes, written once and read once:
// ≈1.6 GB at the wide train-step tier, ≈0.5 ms of each direction at
// 3.35 TB/s).
//
// Design. A per-block dW partial read and written whole (1.1 MB at lego
// widths) once per tile would move ≈6.5 GB at the wide tier, about twice
// the tensor-core bound of the whole kernel. The TPU kernel keeps dW in its
// output block across a grid that runs in order; on the card, blocks run
// in no order, so the sum over rows is a product of its own, and the
// kernel runs in two phases:
// - Phase 1, one 256-thread block per 32-row tile, two blocks an SM:
//   recompute the forward, chain the cotangents back, write demb, dd, dex3
//   and dw, and write each layer's input X and gated cotangent dz to a
//   scratch the wrapper allocates, split into TF32 hi and lo planes as
//   they are stored. Every product runs in place on one [32, ld] buffer in
//   shared memory (the products read it before the epilogue writes), so
//   the tile needs no buffer per layer: the LeakyReLU gates of the chain
//   are read back from the scratch's hi planes (TF32 rounding keeps
//   signs). x·W and dz·Wᵀ run on tf32::tile_gemm's mma.sync tiles (one
//   pass of up to 288 columns, so C1 = 284 and X3 = 263 take one), the
//   weights and their transposes split once per launch into TF32 hi and lo
//   planes; the chain's small cross terms accumulate apart from hi·hi, so
//   the big terms' accumulation does not round them away (K2's dd, which
//   PE scales by up to 2^4, missed its 1e-4 tolerance without that).
// - Phase 2, wgrad_kernel: dW_l = X_lᵀ·dz_l over all rows for every layer,
//   a split-K tensor-core product (blocks of 64 rows of dW × all of its
//   ≤256 columns, over a split of the rows; about two blocks per SM) on
//   the planes phase 1 wrote, with the bias gradients as column sums of dz
//   in the first row block. The alpha head's gradient (257 floats) is
//   summed per tile in phase 1.
// - The split partials are summed in split order (reduce_splits), the
//   tiles' head rows by a fixed tree (reduce_head). No float atomics, so
//   two runs on one device give bit-identical gradients.
// mma.sync rather than wgmma: TF32 wgmma takes both operands K-major from
// shared memory, and the three product shapes here (x·W, dz·Wᵀ, Xᵀ·dz)
// read the same buffers in different orientations; mma.sync fragments are
// loaded by index arithmetic. PE uses full-precision sinf/cosf. The tile
// code lives in trunk_bwd.cuh, which K5 (shade_bwd.cu) shares.

#include "trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
trunk_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
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
    trunk_bwd_tile(p, tile, t, s);
  }
}

}  // namespace

// Floats of the workspace trunk_bwd and shade_bwd take (split weights,
// scratch, head rows, split partials) for S rows of widths Fe, Dd, E3.
extern "C" long long trunk_bwd_workspace(int S, int Fe, int Dd, int E3,
                                         int nf, int nd, int H1, int H3,
                                         int L1, int L3, int order1) {
  Params p{};
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.order1 = order1;
  setup(p);
  return (long long)plan(p, nullptr, sm_count(), nullptr, nullptr, nullptr,
                         nullptr).floats;
}

// dweights receives every layer's gradient, flat, in the order
// w1 [C1,H1], b1, (w12 [H1,H1], b12), w3 [H1+E3,H3], b3, (w32, b32),
// (wa [H3], ba); ws holds ws_floats floats (trunk_bwd_workspace's count).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int trunk_bwd(const float* emb, const float* d, const float* ex3,
                         const float* w, const float* dfeat,
                         const float* dalpha, const float* w1, const float* b1,
                         const float* w12, const float* b12, const float* w3,
                         const float* b3, const float* w32, const float* b32,
                         const float* wa, const float* ba, float* demb,
                         float* dd, float* dex3, float* dw, float* ws,
                         long long ws_floats, float* dweights, int S, int Fe,
                         int Dd, int E3, int nf, int nd, int H1, int H3,
                         int L1, int L3, int K, int act_super, int order1,
                         void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w; p.dfeat = dfeat;
  p.dalpha = dalpha; p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32;
  p.wa = wa; p.ba = ba;
  p.demb = demb; p.dd = dd; p.dex3 = dex3; p.dw = dw;
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const size_t smem = setup(p);
  const Plan pl = plan(p, ws, sm_count(), w1, w12, w3, w32);
  if (check_plan(p, pl, ws_floats)) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(trunk_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = tf32::launch_split(pl.job, st);
  if (err != cudaSuccess) return (int)err;
  trunk_bwd_kernel<<<pl.tiles, THREADS, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad(p, pl, dweights, st);
}
