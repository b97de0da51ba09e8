// Row scatter-add: out[idx[i], :] += upd[i, :] into an [n_rows, C] table
// that this call zeroes first, rows whose index is negative skipped
// (Hopper). An index at or past n_rows traps the kernel, as index_put_'s
// device-side assert does: the error surfaces at the caller's next
// synchronising call, and the context is lost, so a bad index never drops
// gradient silently.
//
// Replaces: scripts/scatter_pallas.py::pallas_scatter, kernel `_kernel`
// (:68, pallas_call :84), the floor of the point-gradient scatter: the
// backward of the packed attribute gather every train step runs
// (pointnerf_tpu/models/neural_points.py:190-203). The TPU version keeps the
// whole [cap, C] accumulator in VMEM (17.2 MB at cap 102,400, C 42) and
// walks the input rows in order on its one core.
//
// What bounds it: bytes. The indices are read once, the kept entries'
// updates once (4·C B each; a skipped entry's are never read), and the table
// written once; at a train step's wide tier (S 96,000 int64 indices, 65,663
// skipped, cap 102,400, C 42) that is ≈23 MB, ≈0.007 ms at 3.35 TB/s, of
// which the table's 17.2 MB is most.
//
// Design: the H100's analogue of the resident accumulator is its 50 MB L2,
// which holds the whole table at these sizes, so the sums go to global
// memory as reductions (`red.global.add`, issued for an atomicAdd whose
// result is unused) and stay in L2. The table is zeroed by a
// cudaMemsetAsync on the same stream, inside this call.
//  - One warp per block of 32 entries: each lane reads one index (int32 or
//    int64, a template, so the caller converts nothing), in one coalesced
//    load, and checks it against n_rows. A __ballot_sync of the kept lanes
//    lets the warp walk only the kept entries, with no compaction pass and
//    no divide: for each, lanes 0..C/2-1 issue the row's float2 reductions
//    (sm_90's atomicAdd(float2*), one per column pair of an 8-byte-aligned
//    row; an odd C takes one float reduction per column). A skipped entry
//    costs its index's bytes and nothing else.
//  - kUnroll kept entries go through at once, their update loads issued
//    before their reductions, so a warp has that many row loads in flight.
//  - A persistent grid of kCtasPerSm CTAs per SM strides over the blocks.
// At C = 42 lanes 21-31 idle while a row goes out (66% lane use). sm_90's
// float4 reductions, half the requests, measured slower on the H100 (0.066
// against 0.051 ms at scatter_pallas.py's shape). Entries
// that land on one row serialise in L2. Float atomics sum in no fixed order:
// the result differs from launch to launch in the last bits.

#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename IdxT, bool kPairs>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const IdxT* __restrict__ idx,
                        const float* __restrict__ upd,
                        float* __restrict__ out, long long S, int C,
                        int n_rows) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  const int per_row = kPairs ? C / 2 : C;
  for (long long base = warp * 32; base < S; base += n_warps * 32) {
    const long long i = base + lane;
    const long long r = i < S ? (long long)__ldg(idx + i) : -1;
    if (r >= n_rows) {
      printf("scatter_rows: index %lld of entry %lld is past n_rows %d\n", r,
             i, n_rows);
      __trap();
    }
    unsigned kept = __ballot_sync(kFull, r >= 0);
    while (kept) {
      int src[kUnroll];
      long long row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        src[u] = kept ? __ffs(kept) - 1 : -1;
        kept &= kept - 1;
        row[u] = __shfl_sync(kFull, r, src[u] < 0 ? 0 : src[u]);
      }
      for (int j = lane; j < per_row; j += 32) {
        if (kPairs) {
          float2 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (src[u] >= 0)
              v[u] = __ldg(reinterpret_cast<const float2*>(
                               upd + (base + src[u]) * C) + j);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (src[u] >= 0)
              atomicAdd(reinterpret_cast<float2*>(out + row[u] * C) + j,
                        v[u]);
        } else {
          float v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (src[u] >= 0) v[u] = __ldg(upd + (base + src[u]) * C + j);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (src[u] >= 0) atomicAdd(out + row[u] * C + j, v[u]);
        }
      }
    }
  }
}

template <typename IdxT>
void launch(const IdxT* idx, const float* upd, float* out, long long S, int C,
            int n_rows, int blocks, cudaStream_t s) {
  if (C % 2 == 0)
    scatter_rows_kernel<IdxT, true>
        <<<blocks, kThreads, 0, s>>>(idx, upd, out, S, C, n_rows);
  else
    scatter_rows_kernel<IdxT, false>
        <<<blocks, kThreads, 0, s>>>(idx, upd, out, S, C, n_rows);
}

}  // namespace

// Zeroes out [n_rows, C] and scatters into it; returns the first CUDA
// error of the memset and the launch (0 = both enqueued). idx [S] is int32
// (idx_bytes 4) or int64 (idx_bytes 8); upd [S, C] and out are contiguous,
// upd 8-byte aligned.
extern "C" int scatter_rows(const void* idx, const float* upd, float* out,
                            int S, int C, int n_rows, int idx_bytes,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes != 4 && idx_bytes != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_rows * (size_t)C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (S > 0 && C > 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    const long long warps = ((long long)S + 31) / 32;
    const long long need = (warps * 32 + kThreads - 1) / kThreads;
    const int blocks = (int)(need < (long long)sms * kCtasPerSm
                                 ? need
                                 : (long long)sms * kCtasPerSm);
    if (idx_bytes == 4)
      launch((const int*)idx, upd, out, S, C, n_rows, blocks, s);
    else
      launch((const long long*)idx, upd, out, S, C, n_rows, blocks, s);
  }
  return (int)cudaGetLastError();
}
