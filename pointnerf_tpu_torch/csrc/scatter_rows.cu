// Row scatter-add: out[idx[i], :] += upd[i, :] into a zeroed [n_rows, C]
// table, rows whose index is negative skipped (Hopper). An index at or past
// n_rows traps the kernel, as index_put_'s device-side assert does: the
// error surfaces at the caller's next synchronising call, and the context
// is lost, so a bad index never drops gradient silently.
//
// Replaces: scripts/scatter_pallas.py::pallas_scatter, kernel `_kernel`
// (:68, pallas_call :84), the floor of the point-gradient scatter: the
// backward of the packed attribute gather every train step runs
// (pointnerf_tpu/models/neural_points.py:190-203). The TPU version keeps the
// whole [cap, C] accumulator in VMEM (17.2 MB at cap 102,400, C 42) and
// walks the input rows in order on its one core.
//
// What bounds it: bytes. Each input row is read once (idx 4 B + 4·C B) and
// each output row written once; at the script's shapes (S 384,000, cap
// 102,400, C 42) that is ≈83 MB, ≈0.025 ms at 3.35 TB/s.
//
// Design: the H100's analogue of the resident accumulator is its 50 MB L2,
// which holds the whole table at these sizes, so the sums go to global
// memory as reductions (`red.global.add`, issued for an atomicAdd whose
// result is unused) and stay in L2. One thread per (input row, column
// pair): neighbouring threads read neighbouring 8-byte pairs of a row, and
// with an even C each row starts 8-byte aligned, so a pair goes out as one
// float2 reduction (sm_90's atomicAdd(float2*, float2)); an odd C takes
// one float reduction per column. Float atomics sum in no fixed order: the
// result differs from launch to launch in the last bits.

#include <cstdio>

#include <cuda_runtime.h>

namespace {

template <bool kPairs>
__global__ void scatter_rows_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ upd,
                                    float* __restrict__ out, int S, int C,
                                    int n_rows) {
  const int per_row = kPairs ? C / 2 : C;
  const long long n = (long long)S * per_row;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const long long i = t / per_row;
    const int j = (int)(t - i * per_row);
    const int r = __ldg(idx + i);
    if (r < 0) continue;
    if (r >= n_rows) {
      printf("scatter_rows: index %d of entry %lld is past n_rows %d\n", r,
             i, n_rows);
      __trap();
    }
    if (kPairs) {
      const float2 v =
          __ldg(reinterpret_cast<const float2*>(upd + i * C) + j);
      atomicAdd(reinterpret_cast<float2*>(out + (long long)r * C) + j, v);
    } else {
      atomicAdd(out + (long long)r * C + j, __ldg(upd + i * C + j));
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `out` must be
// zeroed by the caller; upd [S, C] and out [n_rows, C] are contiguous.
extern "C" int scatter_rows(const int* idx, const float* upd, float* out,
                            int S, int C, int n_rows, void* stream) {
  const bool pairs = (C % 2) == 0;
  const long long n = (long long)S * (pairs ? C / 2 : C);
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    if (pairs)
      scatter_rows_kernel<true><<<(unsigned)blocks, 256, 0,
                                  (cudaStream_t)stream>>>(idx, upd, out, S, C,
                                                          n_rows);
    else
      scatter_rows_kernel<false><<<(unsigned)blocks, 256, 0,
                                   (cudaStream_t)stream>>>(idx, upd, out, S,
                                                           C, n_rows);
  }
  return (int)cudaGetLastError();
}
