// The trunk's first-layer input x0 = [emb, PE(emb), PE(d)] of one tile,
// shared by the forward (trunk_fwd.cuh) and the backward (trunk_bwd.cuh).
// PE column j of a D-channel input with F frequencies is channel j/(2F),
// frequency (j/2)%F: sin(x·2^f) for even j, cos (= sin(x·2^f + pi/2)) for
// odd j, with the full-precision sinf (its arguments reach 2^4·|x|, where
// __sinf loses digits).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pe {

constexpr float HALF_PI = 1.57079637050628662109375f;  // float32(pi/2)

// PE sine argument of column j: x·2^f plus pi/2 on the odd (cos) columns.
__device__ __forceinline__ float arg(float x, int j, int F) {
  const int f = (j >> 1) % F;
  return __fadd_rn(__fmul_rn(x, (float)(1 << f)), (j & 1) ? HALF_PI : 0.f);
}

// x0 of rows row0 .. row0 + ROWS into buf [ROWS, ld]: columns [0, C1) for
// rows < S, zeros past S and in columns [C1, c1p). Row r reads emb at
// emb[(row0 + r)·Fe] and its distances at d_t[r·dd]. Each thread takes a
// column and 32 rows at a time, so a column's channel and frequency are
// worked out once, not per entry.
template <int ROWS, int THREADS>
__device__ void build_x0(const float* __restrict__ emb, int Fe,
                         const float* d_t, int dd, int nf, int nd, int row0,
                         int S, int C1, int c1p, float* buf, int ld) {
  constexpr int RB = 32;
  const int pe_e = 2 * nf * Fe;
  for (int i = threadIdx.x; i < c1p * (ROWS / RB); i += THREADS) {
    const int c = i % c1p, r0 = (i / c1p) * RB;
    int kind = 3, ch = 0, j = 0, F = 1;   // 0 emb, 1 PE(emb), 2 PE(d), 3 zero
    if (c < Fe) {
      kind = 0; ch = c;
    } else if (c < Fe + pe_e) {
      kind = 1; j = c - Fe; F = nf; ch = j / (2 * nf);
    } else if (c < C1) {
      kind = 2; j = c - Fe - pe_e; F = nd; ch = j / (2 * nd);
    }
    for (int r = r0; r < r0 + RB; ++r) {
      const int g = row0 + r;
      float v = 0.f;
      if (g < S && kind != 3) {
        const float x = kind == 2 ? d_t[r * dd + ch] : emb[(size_t)g * Fe + ch];
        v = kind == 0 ? x : sinf(arg(x, j, F));
      }
      buf[r * ld + c] = v;
    }
  }
}

}  // namespace pe
