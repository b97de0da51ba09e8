// Hopper building blocks of the trunk's bfloat16 kernels (K1b,
// csrc/trunk_fwd_bf16.cu; K2b, csrc/trunk_bwd_bf16.cu): warpgroup matrix
// products (wgmma) on bf16 operands in shared memory, the 128-byte
// swizzled layout they read, an mbarrier ring fed by 1-D bulk copies
// (cp.async.bulk: no tensor map, so the build needs no -lcuda), bulk
// stores back to global memory, and the weight converter.
//
// Layout. A bf16 matrix lives in "panels": a panel holds all rows of 64
// consecutive columns, each row 128 bytes, and the 16-byte chunks of row r
// are XOR-ed with r mod 8 (the 128-byte swizzle). Every panel starts on a
// 1024-byte boundary, so the swizzle the hardware applies from address
// bits 7-9 is the one written here. One 8-row x 128-byte block (an atom)
// is at once:
//  - K-major (the row's 64 columns are the product depth): the A operand
//    x·W reads, and the B operand of x·W when the image holds Wᵀ;
//  - MN-major (the 64 columns are the output dimension, the 8 rows the
//    depth): the transposed reads wgmma takes for 16-bit types through its
//    tnspA / tnspB immediates. So one image of W serves x·W and dz·Wᵀ, and
//    one image of a layer input X serves x·W and Xᵀ·dz.
// Descriptors (PTX ISA, "matrix descriptor"): start address >> 4 in bits
// 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, layout type in 62-63 (1 = 128-byte swizzle). K-major: the stride
// byte offset steps 8 rows (1024 bytes in a panel); the leading offset is
// unused; a k16 slice is the start address plus 32 bytes within the
// 128-byte row. MN-major: the stride byte offset steps 8 rows of depth
// (1024 bytes), the leading byte offset steps 64 columns of output (one
// panel); a k16 slice is the start plus 2048 bytes.
//
// Products: d (+)= A·B over k16 slices, fp32 accumulators in the fragment
// layout of wgmma's D (warp w of the warpgroup holds rows 16w..16w+15;
// lane = 4g + t holds rows 16w + g and 16w + g + 8, columns 8j + 2t and
// 8j + 2t + 1 of every 8-column block j, as d[4j + 2h + e] for row
// 16w + g + 8h, column 8j + 2t + e). Each operand value is a bf16, the
// product of two bf16 is exact in fp32 and the sums are fp32: the function
// of the JAX package's _dot_bf16 (pointnerf_tpu/ops/pallas_trunk.py:112).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int ROW_BYTES = 128;          // one panel row
constexpr int TILE_PANEL = 64 * ROW_BYTES;   // a 64-row panel: 8 KB
constexpr int MAX_STAGE = 256 * ROW_BYTES;   // the largest weight chunk
constexpr int SMEM_MAX = 232448;        // dynamic shared memory of a block

__host__ __device__ constexpr int panels(int n) { return (n + 63) >> 6; }

// Byte offset of element (r, c) of a matrix of `rows` rows (a multiple of
// 8) stored as panels.
__host__ __device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * ROW_BYTES + r * ROW_BYTES +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// {bf16(lo) in the low half, bf16(hi) in the high half}, rounded to
// nearest, ties to even (jnp.astype(bfloat16))
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bfloat16, as an fp32 value
__device__ __forceinline__ float rn(float x) {
  return __uint_as_float(pack(x, 0.f) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

// K-major operand: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 0, 1024);
}

// MN-major operand: 8 rows of depth 1024 bytes apart, 64 output columns
// `panel` bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t panel) {
  return desc(addr, panel, 1024);
}

// ------------------------------------------------------------ wgmma sync
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A·B for m64n256k16 with both operands in shared memory; TA / TB
// select MN-major A / B; acc = 0 overwrites d. Every product of the
// kernels is 256 wide (their widest), its operands zero-padded: a kernel
// that holds accumulators of several widths gets its products serialised
// by ptxas for want of registers (performance warning C7512, with
// spills), while one width compiles without a spill.
template <int TA, int TB>
__device__ __forceinline__ void mma256(float (&d)[128], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}


// d (+)= a·B for m64n64k16 with A from registers (a: the four words of
// the thread's A fragment) and B from shared memory (TB: MN-major)
template <int TB>
__device__ __forceinline__ void mma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

// -------------------------------------------------- barriers and copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive on bar and expect `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// global -> shared, completing on bar (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, in the issuing thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the async proxy (wgmma,
// bulk copies)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Moves registers between warpgroups (every thread of the warpgroup
// executes it): the producer gives its registers up, the consumers take
// them.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier `id` (1..15) over `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A ring of `nst` stages of `stage_bytes` in shared memory (1024-aligned),
// with a full and an empty barrier each. The producer walks the same
// sequence of chunks as the consumers; chunk `it` of the sequence uses
// stage it % nst in round it / nst. full counts one arrival (the
// producer's, with the bytes of its copies), empty one per consumer
// warpgroup.
struct Ring {
  unsigned char* buf;
  uint64_t *full, *empty;
  int nst;
  uint32_t stage_bytes;

  __device__ unsigned char* stage(int it) const {
    return buf + (size_t)(it % nst) * stage_bytes;
  }
  __device__ void wait_full(int it) const {
    mbar_wait(&full[it % nst], (uint32_t)((it / nst) & 1));
  }
  __device__ void wait_empty(int it) const {
    mbar_wait(&empty[it % nst], (uint32_t)(((it / nst) & 1) ^ 1));
  }
  __device__ void release(int it) const { mbar_arrive(&empty[it % nst]); }
};

// ---------------------------------------------------------- weight images
// The B operand of x·W for a weight W [K, N] (row-major fp32, N <= 256):
// Wᵀ in bf16 as panels of 64 input columns over nb = 256 rows (zero past
// K and N), one panel per chunk, chunk c = nb·128 bytes at c·nb·128. K-major
// for x·W; read MN-major it is the B operand of dz·Wᵀ (chunk c gives
// output columns 64c..64c+63 over all nb rows of depth).
struct Image {
  const unsigned char* p;
  int chunks;
  uint32_t chunk_bytes;
};

constexpr int MAX_IMAGES = 4;
struct ConvertJob {
  const float* src[MAX_IMAGES];
  unsigned char* dst[MAX_IMAGES];
  int K[MAX_IMAGES], N[MAX_IMAGES], chunks[MAX_IMAGES];
  int n;
};

constexpr int IMAGE_ROWS = 256;

__host__ __device__ inline size_t image_bytes(int K) {
  return (size_t)panels(K) * IMAGE_ROWS * ROW_BYTES;
}

// one thread per 16-byte chunk of an image row
__global__ void convert_weights(ConvertJob job) {
  for (int m = 0; m < job.n; ++m) {
    constexpr int nb = IMAGE_ROWS;
    const int K = job.K[m], N = job.N[m];
    const float* src = job.src[m];
    const int total = job.chunks[m] * nb * 8;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
      const int q = i & 7, n = (i >> 3) % nb, c = (i >> 3) / nb;
      const int k0 = 64 * c + 8 * (q ^ (n & 7));
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (k0 + e < K && n < N) ? src[(size_t)(k0 + e) * N + n] : 0.f;
      uint4 o;
      o.x = pack(v[0], v[1]);
      o.y = pack(v[2], v[3]);
      o.z = pack(v[4], v[5]);
      o.w = pack(v[6], v[7]);
      *reinterpret_cast<uint4*>(job.dst[m] + (size_t)c * nb * ROW_BYTES +
                                n * ROW_BYTES + q * 16) = o;
    }
  }
}

// Adds W [K, N] to job, its image carved from *ws (advanced, 1024-byte
// aligned from a 1024-aligned start); returns the Image the kernels read.
inline Image add_image(ConvertJob& job, const float* src, int K, int N,
                       unsigned char*& ws) {
  const int i = job.n++;
  job.src[i] = src;
  job.dst[i] = ws;
  job.K[i] = K;
  job.N[i] = N;
  job.chunks[i] = panels(K);
  Image im;
  im.p = ws;
  im.chunks = job.chunks[i];
  im.chunk_bytes = (uint32_t)(IMAGE_ROWS * ROW_BYTES);
  ws += image_bytes(K);
  return im;
}

inline cudaError_t launch_convert(const ConvertJob& job, cudaStream_t stream) {
  if (job.n > 0) convert_weights<<<264, 256, 0, stream>>>(job);
  return cudaGetLastError();
}

}  // namespace wg
