// Fused shade, forward (Hopper, fp32 in 3xTF32 on the tensor cores): the
// front half and the trunk in one kernel.
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_shade_fwd_kernel (:512),
// launched by _shade_fwd_impl (:703, pallas_call :728). Per neighbor row it
// forms the trunk's inputs from the neighbor's attributes (shade_front.cuh:
// distances d_raw, the 1/‖d‖ weight normalized over the row's K-group, the
// clamped conf, ex3), then runs K1's trunk on them (trunk_fwd.cuh) and the
// weighted K-sum. Outputs feat [S/K, H3], alpha [S/K] (order 2), and per
// row w_n (post-norm, pre-conf) and conf_c.
//
// What bounds it: as K1, the trunk's ≈271k multiply-adds a row at lego
// widths, in 3xTF32 on the tensor cores; the front adds ≈60 flops a row,
// and a row reads 46 floats (emb, xyz, xyzp, color, pdir, conf, mask) as
// K1's reads 46 (emb, d, ex3, w), so the bound is K1's at the same rows.
//
// Design: K1's, with a prologue. One 256-thread block takes 64 rows, a
// multiple of K, so each K-group's weight sum is taken over the block's own
// rows. Phase 1: one thread per row computes d_raw and ex3 into shared
// memory (where K1 reads them from global memory) and w_raw. Phase 2: one
// thread per row sums its group's w_raw, writes w_n and conf_c, and sets the
// row's weight w_n·conf_c. Then the shared trunk tile: activations in
// shared memory, the weights split once per launch into TF32 hi and lo
// planes and staged with double-buffered cp.async, mma.sync products. The
// front arrays add 14 floats a row (3.6 KB) to K1's 109 KB.

#include "shade_front.cuh"
#include "trunk_fwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
shade_fwd_kernel(Params p, shade::Front f, float* w_n, float* conf_c) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  float* d_s = s.end;                      // [TILE, dd] trunk input d_raw
  float* ex3_s = d_s + TILE * p.dd;        // [TILE, 7]
  float* wraw = ex3_s + TILE * shade::E3;  // [TILE]
  const int row0 = blockIdx.x * TILE;
  const int r = threadIdx.x, g = row0 + r;
  if (r < TILE)
    wraw[r] = shade::row_front(f, g, p.S, p.K, p.dd, d_s + r * p.dd,
                               ex3_s + r * shade::E3);
  __syncthreads();
  if (r < TILE) {
    float we = 0.f;
    if (g < p.S) {
      const float wn = wraw[r] / fmaxf(shade::group_sum(wraw, r, p.K), 1e-8f);
      const float cc = shade::conf_clamp(f.conf[g]);
      w_n[g] = wn;
      conf_c[g] = cc;
      we = wn * cc;
    }
    s.wrow[r] = we;
  }
  trunk_tile(p, row0, d_s, ex3_s, s);
}

}  // namespace

// Splits the weights into ws (ws_floats floats, trunk_fwd_workspace's
// count), then runs the kernel. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int shade_fwd(const float* emb, const float* xyz, const float* xyzp,
                         const float* color, const float* pdir,
                         const float* conf, const float* mask, const float* sl,
                         const float* slw, const float* ovd, const float* RT,
                         const float* w1, const float* b1, const float* w12,
                         const float* b12, const float* w3, const float* b3,
                         const float* w32, const float* b32, const float* wa,
                         const float* ba, float* feat, float* alpha,
                         float* w_n, float* conf_c, float* ws,
                         long long ws_floats, int S, int Fe,
                         int dist_mode, int nf, int nd, int H1, int H3, int L1,
                         int L3, int K, int act_super, int order1,
                         void* stream) {
  const int dd = dist_mode == 20 ? 6 : 3;
  Params p{};
  p.emb = emb;
  p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32; p.wa = wa; p.ba = ba;
  p.feat = feat; p.alpha = alpha;
  p.S = S; p.Fe = Fe; p.dd = dd; p.E3 = shade::E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const shade::Front f{xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                       dist_mode};
  const size_t smem =
      setup(p) + (size_t)TILE * (dd + shade::E3 + 1) * sizeof(float);
  const tf32::SplitJob job = split_job(p, w1, w12, w3, w32, ws, ws_floats);
  if (job.n < 0) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(shade_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (S + TILE - 1) / TILE;
  if (blocks <= 0) return (int)cudaGetLastError();
  const cudaError_t err = tf32::launch_split(job, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  shade_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      p, f, w_n, conf_c);
  return (int)cudaGetLastError();
}
