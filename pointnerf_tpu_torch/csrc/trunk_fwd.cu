// Fused per-neighbor shading trunk, forward (Hopper, fp32).
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
// so the kernel is compute-bound (fp32 FMA issue). A served 800×800 image
// runs ≈26M rows.
//
// Design (a simple first version): one 256-thread block takes a tile of 64
// rows (a multiple of K, so every shading point's neighbors sit in one
// block and the K-sum needs no atomics). PE is computed from index
// arithmetic into shared memory. Each layer's [64, ≤256] activations live
// in shared memory, ping-ponged between two buffers; the ex3 columns are
// parked beside h so block3 reads one [h, ex3] row. Weights (≈1.35 MB,
// resident in L2) stream through shared memory in 16-row chunks, double
// buffered with cp.async, so the multiply loop reads shared memory only.
// Each thread owns 8 rows × 8 columns of a layer's output: one weight read
// feeds 8 FMAs, and one 16-byte shared-memory broadcast brings a row's next
// 4 inputs. On an H100 80GB HBM3 at 700 W this runs at ≈23 TFLOP/s fp32
// (a 4×8 tile reading weights through L1 ran at 13.5, an 8×8 tile through
// L1 at 15.6). Math is fp32 FMA; the PE sin keeps full-precision sinf (its
// arguments reach 2^4·|x|, where __sinf loses digits). The ragged tail is
// masked, not padded. wgmma / bf16 / TF32 and skipping all-masked budget
// rows are later work. The tile code lives in trunk_fwd.cuh, which K4
// (shade_fwd.cu) shares.

#include "trunk_fwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
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

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trunk_fwd(const float* emb, const float* d, const float* ex3,
                         const float* w, const float* w1, const float* b1,
                         const float* w12, const float* b12, const float* w3,
                         const float* b3, const float* w32, const float* b32,
                         const float* wa, const float* ba, float* feat,
                         float* alpha, int S, int Fe, int dd, int E3, int nf,
                         int nd, int H1, int H3, int L1, int L3, int K,
                         int act_super, int order1, void* stream) {
  Params p{emb, d, ex3, w, w1, b1, w12, b12, w3, b3, w32, b32, wa, ba,
           feat, alpha, S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, K, act_super,
           order1, 0, 0};
  const size_t smem = setup(p);
  cudaFuncSetAttribute(trunk_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (S + TILE - 1) / TILE;
  if (blocks > 0)
    trunk_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
