// Fused per-neighbor shading trunk, forward (Hopper, fp32 in 3xTF32 on the
// tensor cores).
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_fwd_kernel (:168), launched
// by _fused_fwd_impl (:341, pallas_call :364). Per neighbor row it computes
//   x  = [emb, PE(emb), PE(d)]           PE column order channel → freq → (sin, cos)
//   h  = block1(x)                       1-2 LeakyReLU(0.1) layers
//   g  = block3([h, ex3])                1-2 LeakyReLU(0.1) layers
//   a  = softplus(g·wa + ba − 1)         (relu without act_super; order 2 only)
// and the weighted sum over the K neighbors of each shading point:
//   feat[p] = Σ_k w·g,  alpha[p] = Σ_k w·a.
//
// What bounds it: about 271k multiply-adds per row at lego widths
// (284→256, 256², 263→256, 256², 256→1) against 45 floats in and 257/K out,
// so the kernel is compute-bound. In 3xTF32 on the tensor cores (3 TF32
// products per multiply-add at 495 TFLOP/s dense) a row's products take
// 3.3 ns of the card; the split of the activations (two cvt and a subtract
// per operand element), the fragments' shared-memory loads and one barrier
// per 16-deep weight chunk are what an SM issues besides the mma.sync. A
// served 800×800 image runs ≈26M rows.
//
// Design. Every layer product runs on the tensor cores with
// mma.sync.m16n8k8 TF32 in the 3xTF32 split (csrc/tf32_mma.cuh: a·b ≈
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, fp32 accumulators), which keeps
// fp32-level error: one TF32 pass misses the rtol/atol 1e-4 the kernel is
// held to (tests/test_torch_port_tf32.py). mma.sync rather than wgmma:
// wgmma takes TF32 operands only K-major from shared memory, and the
// backward needs x·W, dz·Wᵀ and Xᵀ·dz from the same buffers; mma.sync
// fragments are loaded by index arithmetic, so one tile product serves all
// three. The weights (≈1.35 MB, resident in L2) are split once per launch
// by a small kernel (split_weights) into hi and lo planes, zero-padded to
// multiples of 8; the activations are split in registers as their
// fragments are loaded. One 256-thread block takes a tile of 64 rows (a
// multiple of K, so every shading point's neighbors sit in one block and
// the K-sum needs no atomics); its 8 warps form a 2 × 4 grid, each warp
// 32 rows × 8 n-tiles of 8 columns (64 fp32 accumulators a thread). PE is
// computed into shared memory (trunk_pe.cuh: a thread takes a column and
// 32 rows, so no entry pays an integer divide; full-precision sinf, as its
// arguments reach 2^4·|x|, where __sinf loses digits). Each layer's
// [64, ≤256] activations live in one shared buffer with a row stride ≡ 4
// (mod 32) floats, which every layer overwrites in place (the products
// read it before the epilogue writes); the ex3 columns are parked beside h
// so block3 reads one [h, ex3] row; widths that are not multiples of 8
// (C1 = 284, X3 = 263) are zero-padded there. Weights stream through
// shared memory in 8-row chunks of both planes (row stride ≡ 8 mod 32),
// double-buffered with cp.async. Each k-step issues its 3·16 products
// pass by pass over groups of n-tiles, so consecutive mma.sync go to
// different accumulators (a chain of three on one accumulator waits on
// the tensor pipe's latency). Bias, LeakyReLU, the alpha head and the
// K-sum stay fp32. The ragged tail is masked, not padded. Shared memory:
// 109 KB at lego widths and at most 128 registers a thread, so two blocks
// share an SM and hide each other's barriers, PE and epilogues (one block
// with 16-row chunks ran markedly slower). The tile code lives in
// trunk_fwd.cuh, which K4 (shade_fwd.cu) shares.

#include "trunk_fwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
trunk_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  const int row0 = blockIdx.x * TILE;
  if (threadIdx.x < TILE) {
    const int g = row0 + threadIdx.x;
    s.wrow[threadIdx.x] = g < p.S ? p.w[g] : 0.f;
  }
  trunk_tile(p, row0, p.d + (size_t)row0 * p.dd,
             p.ex3 + (size_t)row0 * p.E3, s);
}

}  // namespace

// Floats of the workspace trunk_fwd and shade_fwd take for the split
// weights, at first-layer width C1.
extern "C" long long trunk_fwd_workspace(int C1, int H1, int E3, int H3,
                                         int L1, int L3) {
  return (long long)fwd_workspace_floats(C1, H1, E3, H3, L1, L3);
}

// Splits the weights into ws (ws_floats floats, trunk_fwd_workspace's
// count), then runs the trunk. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int trunk_fwd(const float* emb, const float* d, const float* ex3,
                         const float* w, const float* w1, const float* b1,
                         const float* w12, const float* b12, const float* w3,
                         const float* b3, const float* w32, const float* b32,
                         const float* wa, const float* ba, float* feat,
                         float* alpha, float* ws, long long ws_floats, int S,
                         int Fe, int dd, int E3, int nf, int nd, int H1,
                         int H3, int L1, int L3, int K, int act_super,
                         int order1, void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w;
  p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32; p.wa = wa; p.ba = ba;
  p.feat = feat; p.alpha = alpha;
  p.S = S; p.Fe = Fe; p.dd = dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const size_t smem = setup(p);
  const tf32::SplitJob job = split_job(p, w1, w12, w3, w32, ws, ws_floats);
  if (job.n < 0) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(trunk_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (S + TILE - 1) / TILE;
  if (blocks <= 0) return (int)cudaGetLastError();
  const cudaError_t err = tf32::launch_split(job, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  trunk_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
