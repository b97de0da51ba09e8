// The front half of the fused shade kernels (csrc/shade_fwd.cu, K4, and
// csrc/shade_bwd.cu, K5): per neighbor row, the trunk's inputs and the
// neighbor weight, from the neighbor's attributes and its shading point's
// sample. A transcription of pointnerf_tpu/ops/pallas_trunk.py::_shade_front
// (:475):
//   d_world = xyz − slw,  n = ‖d_world‖,  nc = max(n, 1e-6)
//   w_raw   = mask / nc
//   w_n     = w_raw / max(Σ_K w_raw, 1e-8),  conf_c = clamp(conf, 1e-4, 1)
//   w_eff   = w_n · conf_c
//   d_raw   = [d_world·RT | xp·zp − sx·sz, yp·zp − sy·sz, zp − sz]  (mode 20;
//             mode 0 keeps the first three)
//   sdir    = pdir·RT,  ex3 = [color | sdir − ovd | ⟨sdir, ovd⟩]
// with RT = Rw2cᵀ. About 60 flops a row against the trunk's 271k
// multiply-adds, so it runs one thread per row, in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace shade {

constexpr int E3 = 7;   // ex3 columns

struct Front {
  const float *xyz, *xyzp, *color, *pdir, *conf, *mask;  // [S,3] / [S,1]
  const float *sl, *slw, *ovd;                            // [S/K, 3]
  const float *RT;                                        // [3, 3]
  int dist_mode;                                          // 0 or 20
};

// Row g's d_raw into d[0, dd) and ex3 into ex3[0, 7) (zeros past S);
// returns its w_raw (0 past S).
__device__ __forceinline__ float row_front(const Front& f, int g, int S,
                                           int K, int dd, float* d,
                                           float* ex3) {
  if (g >= S) {
    for (int j = 0; j < dd; ++j) d[j] = 0.f;
    for (int j = 0; j < E3; ++j) ex3[j] = 0.f;
    return 0.f;
  }
  const int q = g / K;
  float R[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = __ldg(f.RT + i);
  const float dx = f.xyz[3 * g] - f.slw[3 * q];
  const float dy = f.xyz[3 * g + 1] - f.slw[3 * q + 1];
  const float dz = f.xyz[3 * g + 2] - f.slw[3 * q + 2];
  const float n = sqrtf(dx * dx + dy * dy + dz * dz);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = dx * R[j] + dy * R[3 + j] + dz * R[6 + j];
  if (f.dist_mode == 20) {
    const float xp = f.xyzp[3 * g], yp = f.xyzp[3 * g + 1],
                zp = f.xyzp[3 * g + 2];
    const float sx = f.sl[3 * q], sy = f.sl[3 * q + 1], sz = f.sl[3 * q + 2];
    d[3] = xp * zp - sx * sz;
    d[4] = yp * zp - sy * sz;
    d[5] = zp - sz;
  }
  const float px = f.pdir[3 * g], py = f.pdir[3 * g + 1],
              pz = f.pdir[3 * g + 2];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float sd = px * R[j] + py * R[3 + j] + pz * R[6 + j];
    const float ov = f.ovd[3 * q + j];
    ex3[j] = f.color[3 * g + j];
    ex3[3 + j] = sd - ov;
    dot = fmaf(sd, ov, dot);
  }
  ex3[6] = dot;
  return f.mask[g] / fmaxf(n, 1e-6f);
}

// Σ_K w_raw over the K-group of tile row r (the group's rows are tile rows
// too: a tile holds whole groups).
__device__ __forceinline__ float group_sum(const float* v, int r, int K) {
  const int r0 = (r / K) * K;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += v[r0 + k];
  return s;
}

__device__ __forceinline__ float conf_clamp(float c) {
  return fminf(fmaxf(c, 1e-4f), 1.f);
}

}  // namespace shade
