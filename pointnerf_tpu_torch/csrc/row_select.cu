// Segmented occupancy row select: occ[n, d] = rows_g[n, rank[n, d],
// lane[n, d]] as float32 (Hopper).
//
// Replaces: scripts/occ_micro3.py::run_kernel, bodies `kern_batched` (:134)
// and `kern_fori` (:147), pallas_call :171. There each ray caches its U
// distinct 128-voxel occupancy rows and every sample picks its byte with a
// one-hot [D, U] x [U, 128] MXU product followed by a one-hot lane select,
// because a per-sample scalar gather was latency-bound on the TPU.
//
// What bounds it: bytes. Each sample reads its rank and lane (8 B) and
// writes one float (4 B); rows_g is read once (U·LW bytes a ray for int8
// rows, twice that for bf16), unless the caller broadcasts one row set to
// every ray (ray stride 0), as the micro-benchmark does.
//
// Design: the function, not the TPU's one-hot product, which was a
// workaround for the gather. One thread per (ray, sample) reads rank and
// lane and one byte (int8) or half (bf16) of its ray's rows. `rays_per_cta`
// plays the TPU's Rt (rays per grid step): a CTA of 256 threads walks its
// rays' samples. The row type is a template, int8 (the grid's own) or
// bf16; both hold 0/1 exactly. rank is clamped to [0, U) and lane to
// [0, LW), as the plain version clamps them; rank >= U (overflow) is the
// caller's to handle, as in the script.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void row_select_kernel(const T* __restrict__ rows,
                                  const int* __restrict__ rank,
                                  const int* __restrict__ lane,
                                  float* __restrict__ out, int N, int D, int U,
                                  int LW, long long ray_stride,
                                  int rays_per_cta) {
  const int n0 = blockIdx.x * rays_per_cta;
  const int n1 = min(N, n0 + rays_per_cta);
  const long long lo = (long long)n0 * D, hi = (long long)n1 * D;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const long long n = i / D;
    const int r = min(max(__ldg(rank + i), 0), U - 1);
    const int l = min(max(__ldg(lane + i), 0), LW - 1);
    out[i] = to_float(rows[n * ray_stride + (long long)r * LW + l]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). dtype: 0 =
// int8 rows, 1 = bf16 rows. rank, lane and out are contiguous [N, D]; row
// n's [U, LW] block starts ray_stride elements after row n-1's.
extern "C" int row_select(const void* rows, const int* rank, const int* lane,
                          float* out, int N, int D, int U, int LW,
                          long long ray_stride, int rays_per_cta, int dtype,
                          void* stream) {
  if (N > 0 && D > 0) {
    const unsigned blocks = (unsigned)((N + rays_per_cta - 1) / rays_per_cta);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
      row_select_kernel<int8_t><<<blocks, 256, 0, s>>>(
          (const int8_t*)rows, rank, lane, out, N, D, U, LW, ray_stride,
          rays_per_cta);
    else
      row_select_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          (const __nv_bfloat16*)rows, rank, lane, out, N, D, U, LW,
          ray_stride, rays_per_cta);
  }
  return (int)cudaGetLastError();
}
