// Segmented occupancy row select: occ[n, d] = rows_g[n, rank[n, d],
// lane[n, d]] as float32 (Hopper).
//
// Replaces: scripts/occ_micro3.py::run_kernel, bodies `kern_batched` (:134)
// and `kern_fori` (:147), pallas_call :171. There each grid step stages its
// Rt rays' [U, 128] occupancy rows in VMEM (:175-176), and every sample
// picks its byte with a one-hot [D, U] x [U, 128] MXU product followed by a
// one-hot lane select, because a per-sample scalar gather was latency-bound
// on the TPU.
//
// What bounds it: bytes. Each sample reads its rank and lane (8 B) and
// writes one float (4 B), and reads one byte (int8) or half (bf16) of its
// ray's [U, LW] block: at least the 32-byte sectors its samples touch, at
// most the whole block (12,288 B for int8 rows at U 96, LW 128). One row set
// broadcast to every ray (ray stride 0, as in the micro-benchmark) is read
// once.
//
// Design: the TPU kernel's staging, in Hopper form. A CTA walks its
// `rays_per_cta` rays (the TPU's Rt) with up to four groups of 128 threads,
// group g taking rays g, g+G, g+2G, ... so that G rays are selected at once.
//  - First each warp finds the span of some of the CTA's rays: the rows
//    between its least and its largest clamped rank (a segmented ray's ranks
//    count its distinct rows, so the span is the rows it holds, not all U).
//  - Each group double-buffers its rays' spans in shared memory: one thread
//    issues a 1-D bulk asynchronous copy (`cp.async.bulk`, completing on an
//    mbarrier) of ray j+2's span into the buffer ray j has just released,
//    so the next rows land while a ray is selected. The copy takes 16-byte
//    aligned blocks; the wrapper rejects others.
//  - With ray stride 0 the CTA copies the one block once, whole.
//  - Samples go four to a thread: rank and lane are loaded as int4 and the
//    output stored as float4, the ray's sample index coming from the loop
//    (no divide); a ray whose samples do not start on a 16-byte boundary
//    (D not a multiple of 4) takes its first and last few scalar.
// A ray's ranks are read twice (span, then select), the second time from
// L2. The staged rows still exceed the sectors a byte gather touches.
// The row type is a template, int8 (the grid's own) or bf16; both hold 0/1
// exactly. rank is clamped to [0, U) and lane to [0, LW), as the plain
// version clamps them; rank >= U (overflow) is the caller's to handle, as in
// the script.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 128;
constexpr int kMaxGroups = 4;
constexpr int kSmemBudget = 96 * 1024;   // the buffers of all groups
constexpr int kSmemMax = 231424;         // sm_90's 227 KiB a CTA, less 1 KiB
                                         // for the static barriers

__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global to shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ float pick(const T* blk, int r, int l, int U,
                                      int LW) {
  r = min(max(r, 0), U - 1);
  l = min(max(l, 0), LW - 1);
  return to_float(blk[r * LW + l]);
}

// The D samples of ray n against its staged rows, by the 128 threads of
// one group (t = the thread's rank in it). `blk` points where row 0 of the
// ray's block would sit: only the rows of the ray's span are staged.
template <typename T>
__device__ __forceinline__ void select_ray(const T* blk,
                                           const int* __restrict__ rank,
                                           const int* __restrict__ lane,
                                           float* __restrict__ out, int n,
                                           int D, int U, int LW, bool vec,
                                           int t) {
  const long long s0 = (long long)n * D;
  int head = 0, nv = 0;
  if (vec) {
    head = min(D, (int)((4 - (s0 & 3)) & 3));
    nv = (D - head) >> 2;
    const long long v0 = s0 + head;
    const int4* r4 = reinterpret_cast<const int4*>(rank + v0);
    const int4* l4 = reinterpret_cast<const int4*>(lane + v0);
    float4* o4 = reinterpret_cast<float4*>(out + v0);
    for (int q = t; q < nv; q += kGroupThreads) {
      const int4 r = __ldg(r4 + q), l = __ldg(l4 + q);
      o4[q] = make_float4(pick(blk, r.x, l.x, U, LW), pick(blk, r.y, l.y, U, LW),
                          pick(blk, r.z, l.z, U, LW),
                          pick(blk, r.w, l.w, U, LW));
    }
  }
  // the scalar samples: the head before the first 16-byte boundary and the
  // tail after the last full int4 (every sample when !vec)
  const int n_scalar = D - 4 * nv;
  for (int e = t; e < n_scalar; e += kGroupThreads) {
    const long long i = s0 + (e < head ? e : e + 4 * nv);
    out[i] = pick(blk, __ldg(rank + i), __ldg(lane + i), U, LW);
  }
}

// The bytes [lo, hi) of a ray's block that hold the rows its clamped ranks
// reach, widened to 16-byte boundaries (the block is a multiple of 16).
struct Span {
  uint32_t lo, hi;
};

// One warp: the span of ray n (a pass over its ranks, min and max clamped).
__device__ __forceinline__ Span ray_span(const int* __restrict__ rank, int n,
                                         int D, int U, uint32_t row_bytes,
                                         int lane_id) {
  const int* r = rank + (long long)n * D;
  int lo = U - 1, hi = 0;
#pragma unroll 4
  for (int e = lane_id; e < D; e += 32) {
    const int v = min(max(__ldg(r + e), 0), U - 1);
    lo = min(lo, v);
    hi = max(hi, v);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  return {(lo * row_bytes) & ~15u, ((hi + 1) * row_bytes + 15) & ~15u};
}

template <typename T>
__global__ void __launch_bounds__(kGroupThreads* kMaxGroups)
    row_select_kernel(const T* __restrict__ rows,
                      const int* __restrict__ rank,
                      const int* __restrict__ lane, float* __restrict__ out,
                      int N, int D, int U, int LW, long long ray_stride,
                      int rays_per_cta, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxGroups];
  const int G = blockDim.x / kGroupThreads;
  const int g = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  const int n0 = blockIdx.x * rays_per_cta;
  const int nr = min(N - n0, rays_per_cta);
  const bool shared_rows = ray_stride == 0;
  const uint32_t row_bytes = (uint32_t)(LW * sizeof(T));
  const uint32_t block_bytes = U * row_bytes;
  const unsigned char* ray0 =
      reinterpret_cast<const unsigned char*>(rows + (long long)n0 * ray_stride);
  // the spans of the CTA's rays sit after the buffers
  Span* spans = reinterpret_cast<Span*>(
      smem + (shared_rows ? 1 : 2 * G) * block_bytes);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 * G; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (shared_rows) {
    __syncthreads();
    if (threadIdx.x == 0) bulk_load(smem, rows, block_bytes, &bars[0]);
  } else {
    // each warp finds the spans of some of the CTA's rays
    for (int k = threadIdx.x / 32; k < nr; k += blockDim.x / 32) {
      const Span sp = ray_span(rank, n0 + k, D, U, row_bytes, threadIdx.x % 32);
      if (threadIdx.x % 32 == 0) spans[k] = sp;
    }
    __syncthreads();
    if (t == 0)
      for (int j = 0; j < 2 && g + j * G < nr; ++j) {
        const int k = g + j * G;
        bulk_load(smem + (2 * g + j) * block_bytes + spans[k].lo,
                  ray0 + k * ray_stride * sizeof(T) + spans[k].lo,
                  spans[k].hi - spans[k].lo, &bars[2 * g + j]);
      }
  }
  // the group's j-th ray (k = g + j·G) sits in buffer 2g + (j & 1), filled
  // for the (j >> 1)-th time
  for (int j = 0, k = g; k < nr; ++j, k += G) {
    const int b = shared_rows ? 0 : 2 * g + (j & 1);
    mbar_wait(&bars[b], shared_rows ? 0u : (uint32_t)((j >> 1) & 1));
    select_ray(reinterpret_cast<const T*>(smem + b * block_bytes), rank, lane,
               out, n0 + k, D, U, LW, vec != 0, t);
    if (!shared_rows && k + 2 * G < nr) {
      // the group has read buffer b: refill it with its ray after next
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kGroupThreads)
                   : "memory");
      if (t == 0) {
        const int k2 = k + 2 * G;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(smem + b * block_bytes + spans[k2].lo,
                  ray0 + k2 * ray_stride * sizeof(T) + spans[k2].lo,
                  spans[k2].hi - spans[k2].lo, &bars[b]);
      }
    }
  }
}

template <typename T>
int launch(const T* rows, const int* rank, const int* lane, float* out, int N,
           int D, int U, int LW, long long ray_stride, int rays_per_cta,
           int vec, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long block_bytes = (long long)U * LW * sizeof(T);
  int groups = ray_stride == 0 ? kMaxGroups
                               : (int)(kSmemBudget / (2 * block_bytes));
  groups = std::max(1, std::min(std::min(groups, kMaxGroups), rays_per_cta));
  const long long smem =
      ray_stride == 0 ? block_bytes
                      : 2 * groups * block_bytes + 8LL * rays_per_cta;
  if (block_bytes % 16 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + rays_per_cta - 1) / rays_per_cta);
  row_select_kernel<T><<<blocks, groups * kGroupThreads, (size_t)smem, s>>>(
      rows, rank, lane, out, N, D, U, LW, ray_stride, rays_per_cta, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the setup and the launch (0 = launched).
// dtype: 0 = int8 rows, 1 = bf16 rows. rank, lane and out are contiguous
// [N, D]; ray n's [U, LW] block starts ray_stride elements after ray n-1's,
// and every block must start 16-byte aligned with a size that is a multiple
// of 16 bytes (the bulk copy's rule; cudaErrorInvalidValue otherwise). vec:
// rank, lane and out all start 16-byte aligned.
extern "C" int row_select(const void* rows, const int* rank, const int* lane,
                          float* out, int N, int D, int U, int LW,
                          long long ray_stride, int rays_per_cta, int dtype,
                          int vec, void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaSuccess;
  const int esize = dtype == 0 ? 1 : 2;
  if (rays_per_cta <= 0 || U <= 0 || LW <= 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 || (ray_stride * esize) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch((const int8_t*)rows, rank, lane, out, N, D, U, LW,
                  ray_stride, rays_per_cta, vec, s);
  return launch((const __nv_bfloat16*)rows, rank, lane, out, N, D, U, LW,
                ray_stride, rays_per_cta, vec, s);
}
