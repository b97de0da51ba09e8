// Fused shade, backward (Hopper, fp32 in 3xTF32 on the tensor cores): the
// front half, the trunk's backward and the front's backward in one kernel,
// then K2's weight-gradient phase.
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_shade_bwd_kernel (:543),
// launched by _shade_bwd_rule (:758, pallas_call :794). Per tile it
// recomputes the front (shade_front.cuh: d_raw, ex3, the normalized weight
// w_n, the clamped conf, w_eff = w_n·conf_c), runs K2's trunk backward on it
// (trunk_bwd.cuh) with w_eff as the neighbor weight, and turns K2's per-row
// cotangents dd_raw, dex3 and dw_eff into the per-attribute ones:
//   dcolor = dex3[0:3]
//   ddir   = (dex3[3:6] + dex3[6]·ovd)·RTᵀ
//   dxyzp  = [ddp0·zp, ddp1·zp, ddp0·xp + ddp1·yp + ddp2]  (ddp = dd_raw[3:6];
//            mode 20, zeros in mode 0)
//   dconf  = dw_eff·w_n + dconfout          (the conf clamp is identity-bwd)
//   dw_n   = dw_eff·conf_c + dwout
//   dw_raw = (dw_n − [S_w > 1e-8]·Σ_K dw_n·w_n) / max(S_w, 1e-8)
//   dxyz   = dd_raw[0:3]·RTᵀ − [n > 1e-6]·(w_raw/nc)·dw_raw·d_world/nc
// with S_w = Σ_K w_raw over the row's K-group, as _shade_bwd_kernel's
// :630-656. The weight and bias gradients are K2's.
//
// What bounds it: as K2, about 3x the forward's ≈271k multiply-adds a row
// at lego widths in 3xTF32 on the tensor cores, plus the scratch between
// its two phases; the front and its backward add about 150 flops a row,
// and a row reads 48 floats and writes 45 where K2's reads 46 and writes
// 46, so the bound is K2's at the same rows.
//
// Design: K2's, with a prologue and an epilogue in phase 1. Each block
// takes a 32-row tile (a multiple of K, so every K-group's sums are taken
// over the block's own rows). Prologue: one thread per row computes d_raw and ex3
// into shared memory (where K2 reads them from global memory) and w_raw;
// after a barrier it sums its group's w_raw and sets w_eff. The trunk
// backward then writes dd_raw, dex3 and dw_eff of the tile to shared
// memory, where the epilogue (one thread per row again, a barrier between
// the two group sums) reads them. The front arrays add 31 floats a row
// (4.0 KB) to K2's 76 KB. The weight gradients are K2's phase 2
// (trunk_bwd.cuh::launch_wgrad) over the scratch phase 1 wrote, in its
// fixed summation order, so two runs give bit-identical weight gradients.

#include "shade_front.cuh"
#include "trunk_bwd.cuh"

namespace {

struct Cotangents {
  const float *dwout, *dconfout;                // [S, 1]
  float *dxyz, *dxyzp, *dcolor, *ddir, *dconf;  // [S, 3] x 4, [S, 1]
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
shade_bwd_kernel(Params p, shade::Front f, Cotangents o) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  const int dd = p.Dd, E3 = shade::E3;
  float* d_s = s.end;                  // [TILE, dd] d_raw
  float* ex3_s = d_s + TILE * dd;      // [TILE, 7]
  float* dd_s = ex3_s + TILE * E3;     // [TILE, dd] dd_raw
  float* dex3_s = dd_s + TILE * dd;    // [TILE, 7]
  float* dw_s = dex3_s + TILE * E3;    // [TILE] dw_eff
  float* wraw = dw_s + TILE;           // [TILE] w_raw
  float* wn_s = wraw + TILE;           // [TILE] w_n
  float* cc_s = wn_s + TILE;           // [TILE] conf_c
  float* prod = cc_s + TILE;           // [TILE] dw_n·w_n
  const int r = threadIdx.x;
  const int ntiles = (p.S + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TILE, g = row0 + r;
    const bool row = r < TILE && g < p.S;

    // ---- front
    if (r < TILE)
      wraw[r] = shade::row_front(f, g, p.S, p.K, dd, d_s + r * dd,
                                 ex3_s + r * E3);
    __syncthreads();
    if (r < TILE) {
      float wn = 0.f, cc = 0.f;
      if (row) {
        wn = wraw[r] / fmaxf(shade::group_sum(wraw, r, p.K), 1e-8f);
        cc = shade::conf_clamp(f.conf[g]);
      }
      wn_s[r] = wn;
      cc_s[r] = cc;
      s.wrow[r] = wn * cc;
    }

    // ---- trunk backward (ends with a barrier)
    const Tile t{d_s, ex3_s, dd_s, dex3_s, dw_s};
    trunk_bwd_tile(p, tile, t, s);

    // ---- front backward
    float dw_n = 0.f;
    if (row) {
      const float dwe = dw_s[r];
      o.dconf[g] = fmaf(dwe, wn_s[r], o.dconfout[g]);
      dw_n = fmaf(dwe, cc_s[r], o.dwout[g]);
    }
    if (r < TILE) prod[r] = dw_n * wn_s[r];
    __syncthreads();
    if (row) {
      const int q = g / p.K;
      float R[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = __ldg(f.RT + i);
      const float* dx3 = dex3_s + r * E3;
      const float* ddr = dd_s + r * dd;
      float dsd[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o.dcolor[3 * g + j] = dx3[j];
        dsd[j] = fmaf(dx3[6], f.ovd[3 * q + j], dx3[3 + j]);
      }
      // x·RTᵀ: out[j] = Σ_i x[i]·RT[j, i]
#pragma unroll
      for (int j = 0; j < 3; ++j)
        o.ddir[3 * g + j] =
            dsd[0] * R[3 * j] + dsd[1] * R[3 * j + 1] + dsd[2] * R[3 * j + 2];
      if (dd == 6) {
        const float xp = f.xyzp[3 * g], yp = f.xyzp[3 * g + 1],
                    zp = f.xyzp[3 * g + 2];
        o.dxyzp[3 * g] = ddr[3] * zp;
        o.dxyzp[3 * g + 1] = ddr[4] * zp;
        o.dxyzp[3 * g + 2] = ddr[3] * xp + ddr[4] * yp + ddr[5];
      } else {
        o.dxyzp[3 * g] = o.dxyzp[3 * g + 1] = o.dxyzp[3 * g + 2] = 0.f;
      }
      const float S_w = shade::group_sum(wraw, r, p.K);
      const float gated = S_w > 1e-8f ? shade::group_sum(prod, r, p.K) : 0.f;
      const float dw_raw = (dw_n - gated) / fmaxf(S_w, 1e-8f);
      const float dw[3] = {f.xyz[3 * g] - f.slw[3 * q],
                           f.xyz[3 * g + 1] - f.slw[3 * q + 1],
                           f.xyz[3 * g + 2] - f.slw[3 * q + 2]};
      const float n = sqrtf(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]);
      const float nc = fmaxf(n, 1e-6f);
      const float dnc = n > 1e-6f ? -wraw[r] / nc * dw_raw : 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        o.dxyz[3 * g + j] = ddr[0] * R[3 * j] + ddr[1] * R[3 * j + 1] +
                            ddr[2] * R[3 * j + 2] + dnc * dw[j] / nc;
    }
    __syncthreads();   // the next tile rewrites the front arrays
  }
}

}  // namespace

// dweights receives every layer's gradient, flat, in trunk_bwd's order;
// ws holds ws_floats floats (trunk_bwd_workspace's count at Dd = 6 for
// dist mode 20, 3 for mode 0, and E3 = 7). Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int shade_bwd(const float* emb, const float* xyz, const float* xyzp,
                         const float* color, const float* pdir,
                         const float* conf, const float* mask, const float* sl,
                         const float* slw, const float* ovd, const float* RT,
                         const float* dfeat, const float* dalpha,
                         const float* dwout, const float* dconfout,
                         const float* w1, const float* b1, const float* w12,
                         const float* b12, const float* w3, const float* b3,
                         const float* w32, const float* b32, const float* wa,
                         const float* ba, float* demb, float* dxyz,
                         float* dxyzp, float* dcolor, float* ddir,
                         float* dconf, float* ws, long long ws_floats,
                         float* dweights, int S, int Fe, int dist_mode, int nf,
                         int nd, int H1, int H3, int L1, int L3, int K,
                         int act_super, int order1, void* stream) {
  const int dd = dist_mode == 20 ? 6 : 3;
  Params p{};
  p.emb = emb; p.dfeat = dfeat; p.dalpha = dalpha;
  p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32; p.wa = wa; p.ba = ba;
  p.demb = demb;
  p.S = S; p.Fe = Fe; p.Dd = dd; p.E3 = shade::E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const shade::Front f{xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                       dist_mode};
  const Cotangents o{dwout, dconfout, dxyz, dxyzp, dcolor, ddir, dconf};
  const size_t smem = setup(p) +
      (size_t)TILE * (2 * dd + 2 * shade::E3 + 5) * sizeof(float);
  const Plan pl = plan(p, ws, sm_count(), w1, w12, w3, w32);
  if (check_plan(p, pl, ws_floats)) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(shade_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = tf32::launch_split(pl.job, st);
  if (err != cudaSuccess) return (int)err;
  shade_bwd_kernel<<<pl.tiles, THREADS, smem, st>>>(p, f, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad(p, pl, dweights, st);
}
