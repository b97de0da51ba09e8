// Per-sample occupancy of the dilated voxel grid (Hopper).
//
// Replaces: pointnerf_tpu/ops/query.py::mask_raypos_segmented, inner kernel
// `kern` (:122, pallas_call :144). The TPU version caches each ray's <= U
// distinct 128-voxel rows and resolves every sample with a bf16 one-hot
// [D,U]@[U,128] product, because per-sample scalar gathers were
// latency-bound there; rays past U go conservative-valid.
//
// What bounds it: one 1-byte random read per sample (≈11.5M samples per
// 28,800-ray serving group) plus the float math to place the sample —
// memory-latency bound. The dilated table (≈9 MB at lego scale) sits in L2.
//
// Design: one thread per (ray, sample). It rebuilds campos + raydir·t
// (rounded once, as XLA's fused multiply-add rounds it: the float64 sum of
// float32 operands, cast down), floors it to a voxel, checks bounds,
// linearises and reads the int8 byte. The [B,R,D,3] position tensor is
// never materialised and there is no row budget, so the result is exact —
// equal to the dense mask everywhere — and nothing overflows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const float *campos, *raydir, *tvals;   // [B,3], [B,R,3], strided [B,R,D]
  const int8_t* occ;                      // dilated occupancy, row-major volume
  uint8_t* out;                           // [B,R,D] bool
  long long tsb, tsr, tsd;                // tvals element strides
  int B, R, D;
  float mn[3], inv[3];                    // ranges_min, 1/scaled_vsize
  int vdim[3];
};

__global__ void occupancy_kernel(Params p) {
  const long long n = (long long)p.B * p.R * p.D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % p.D);
    const long long br = i / p.D;
    const int r = (int)(br % p.R), b = (int)(br / p.R);
    const double t = (double)p.tvals[b * p.tsb + r * p.tsr + d * p.tsd];
    const float* dir = p.raydir + br * 3;
    bool inb = true;
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __double2float_rn(
          __dadd_rn((double)p.campos[b * 3 + a], __dmul_rn((double)dir[a], t)));
      const float v = floorf(__fmul_rn(__fsub_rn(pos, p.mn[a]), p.inv[a]));
      c[a] = (int)v;
      inb = inb && v >= 0.f && v < (float)p.vdim[a];
    }
    bool occ = false;
    if (inb) occ = p.occ[(c[0] * p.vdim[1] + c[1]) * p.vdim[2] + c[2]] > 0;
    p.out[i] = occ ? 1 : 0;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int occupancy(const float* campos, const float* raydir,
                         const float* tvals, const int8_t* occ, uint8_t* out,
                         long long tsb, long long tsr, long long tsd, int B,
                         int R, int D, float mn0, float mn1, float mn2,
                         float inv0, float inv1, float inv2, int vx, int vy,
                         int vz, void* stream) {
  Params p{campos, raydir, tvals, occ, out, tsb, tsr, tsd, B, R, D,
           {mn0, mn1, mn2}, {inv0, inv1, inv2}, {vx, vy, vz}};
  const long long n = (long long)B * R * D;
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    occupancy_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
