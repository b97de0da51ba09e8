// Fused per-neighbor shading trunk, forward, with bfloat16 product
// operands (Hopper: wgmma on bf16 shared-memory tiles fed by bulk copies).
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_fwd_kernel (:168) with
// bf16=True (dot=_dot_bf16, :176), launched by _fused_fwd_impl (pallas_call
// :364) under --trunk_dtype bfloat16. It computes K1's function
// (csrc/trunk_fwd.cu) with JAX's rounding sites: every MLP product (block1,
// block3 and the alpha head) takes operands rounded to bfloat16 and sums
// in fp32; the PE sine arguments, bias, LeakyReLU, the density activation
// and the weighted K-sum stay fp32:
//   x  = [emb, PE(emb), PE(d)]
//   h  = block1(x),  g = block3([h, ex3]),  a = act(g·wa + ba) (order 2)
//   feat[p] = Σ_k w·g,  alpha[p] = Σ_k w·a.
// Every consumer of an intermediate activation rounds it to bf16 first, so
// the layer inputs are kept as bf16 without changing the function; only
// the last layer's g feeds fp32 (the K-sum) and stays fp32 in registers.
//
// What bounds it: ≈271k multiply-adds a row at lego widths (C1 284, 256
// wide), one bf16 tensor-core product each: 989 TFLOP/s dense, 0.211 /
// 0.421 ms at the serving group's narrow / wide tier (384,000 / 768,000
// rows). Its ≈252 PE sines a row run on the CUDA cores beside them.
//
// Design (csrc/trunk_bf16.cuh, csrc/bf16_wgmma.cuh):
// - A persistent grid, one 384-thread block per SM, over 128-row tiles:
//   two consumer warpgroups own 64 rows each; a producer warpgroup, one
//   thread of which streams the weights, gives its registers to them
//   (setmaxnreg 40 / 232: the 128 accumulators a thread fit).
// - The weights are converted once per launch into their bf16 shared-
//   memory image (Wᵀ in 64-column panels with the 128-byte swizzle, 256
//   rows, one 32 KB chunk per panel). The producer copies chunk after
//   chunk with cp.async.bulk into a ring of four stages completing on
//   mbarriers; the chunk order repeats every tile, so copies stay in
//   flight across layers and tiles, and both warpgroups read each chunk:
//   it leaves L2 once per 128 rows (the mma.sync version streamed every
//   layer again per 64 rows, with two block barriers per 32 rows).
// - Every product is wgmma m64n256k16 with both operands in shared memory
//   (the layer's width zero-padded to 256): with one width in the kernel
//   ptxas keeps the products pipelined without spilling, where several
//   widths make it serialise them (bf16_wgmma.cuh). A chunk is one commit
//   group of four k16 slices, waited for before its stage is released;
//   the other warpgroup's products fill the tensor cores meanwhile.
// - x0 is built in bf16 straight into the swizzled A panels: a column
//   table in shared memory (channel, frequency, sin or cos) leaves no
//   integer division per entry, each thread loads 8 rows' inputs of a
//   column pair before computing them, and the sines take sinf's own fast
//   path without its branch to the Payne-Hanek reduction (trig_fast,
//   bit-equal to sinf; sinf itself past |x| = 105615), so the compiler
//   interleaves them (with per-entry divisions and sinf's branches, x0
//   was the larger part of the kernel's time).
// - The epilogue adds the bias (a zero-padded vector in shared memory) and
//   applies LeakyReLU in registers and writes the output in place as the
//   next layer's bf16 A operand.
// - The last layer's g stays in registers: the alpha head rounds g and wa
//   and sums a row's columns across the 4 threads of a quad; the weighted
//   K-sum takes fp32 w·g, by up to three butterflies over a warp's rows and,
//   for K = 32 or 64 (a shading point over two or four warps), through
//   shared memory.
// Not done: a cluster of two with multicast copies (each chunk would leave
// L2 once per 256 rows).

#include <cuda_runtime.h>
#include <math.h>

#include "trunk_bf16.cuh"

namespace {

using tb::Tile;

constexpr int MAX_STAGES = 4;

struct Params {
  const float *emb, *d, *ex3, *w;
  wg::Image img[4];          // w1, (w12), w3, (w32): the tile's chunk order
  const float* b[4];         // their biases
  int N[4];                  // output widths
  int seq[4];                // 0 .. nl - 1
  const float *wa, *ba;      // [H3], [1]
  float *feat, *alpha;       // [S/K, H3], [S/K]
  int nl, S, Fe, dd, E3, nf, nd, H1, H3, L1, K, act_super, order1, C1;
  int tiles, nst, maxa;
};

// after the A panels and the vectors: red [2][1024], rows [2][128] (wrow,
// arow), barriers
constexpr size_t EXTRA = 2 * 1024 * 4 + 2 * 128 * 4 + 2 * 8 * 8;

// A layer before the last: its product, then its output in place.
__device__ __forceinline__ void hidden(Tile& T, const Params& p, int li,
                                       const float* vec) {
  float acc[tb::ACC];
  tb::product_ss(acc, T, p.img[li]);
  T.sync();
  tb::store_leaky(acc, T, vec + li * tb::VEC, nullptr);
  wg::fence_async();
  T.sync();
}

// The last layer: its product, then feat (and alpha) from the registers.
__device__ __forceinline__ void last(Tile& T, const Params& p, int li,
                                     int row0, const float* wrow,
                                     float* arow, const float* vec) {
  constexpr int NB = 256;
  float acc[tb::ACC];
  tb::product_ss(acc, T, p.img[li]);
  const float* b = vec + li * tb::VEC;
  const float* wa = vec + 4 * tb::VEC;
  const int H = p.H3, t = T.t;
  // g = leaky(acc + b): zero past H (zero products, zero-padded bias)
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] = tb::leaky(acc[4 * j + 2 * h] + bb.x);
      acc[4 * j + 2 * h + 1] = tb::leaky(acc[4 * j + 2 * h + 1] + bb.y);
    }
  }
  const float w_h[2] = {wrow[T.row(0)], wrow[T.row(1)]};
  if (!p.order1) {
    // za = Σ bf(g)·bf(wa) over the row's columns: the thread's, then its
    // quad's four threads
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const float2 ww = *reinterpret_cast<const float2*>(wa + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] = fmaf(wg::rn(acc[4 * j + 2 * h]), ww.x, s[h]);
        s[h] = fmaf(wg::rn(acc[4 * j + 2 * h + 1]), ww.y, s[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      if (t == 0) {
        const float za = s[h] + __ldg(p.ba);
        const float a = p.act_super
                            ? fmaxf(za - 1.f, 0.f) + log1pf(expf(-fabsf(za - 1.f)))
                            : fmaxf(za, 0.f);
        arow[T.row(h)] = a * w_h[h];
      }
    }
  }
  // feat: w·g summed over each shading point's K rows. Row bits 0-2 are
  // lane bits 2-4, bit 3 the thread's second row, bits 4-5 the warp.
  const int K = p.K;
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] *= w_h[(i >> 1) & 1];
  for (int bit = 0; bit < 3; ++bit)
    if (K > (1 << bit)) tb::rows_butterfly(acc, bit);
  if (K >= 16) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      acc[4 * j] += acc[4 * j + 2];
      acc[4 * j + 1] += acc[4 * j + 3];
    }
  }
  if (K <= 16) {
    if (T.g % K == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + T.row(h);
        if ((K < 16 || h == 0) && row < p.S) {
          float* out = p.feat + (size_t)(row / K) * H;
#pragma unroll
          for (int j = 0; j < NB / 8; ++j) {
            const int c = 8 * j + 2 * t;
            if (c < H)   // H % 4 == 0: c + 1 < H too
              *reinterpret_cast<float2*>(out + c) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  } else {
    // K = 32, 64: each warp's 16-row sums, then K / 16 warps in order
    if (T.g == 0) {
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        T.red[T.warp * 256 + 8 * j + 2 * t] = acc[4 * j];
        T.red[T.warp * 256 + 8 * j + 2 * t + 1] = acc[4 * j + 1];
      }
    }
    T.sync();
    const int per = K / 16;
    for (int q = 0; q < 4 / per; ++q) {
      if (row0 + q * K >= p.S) continue;
      float* out = p.feat + (size_t)((row0 + q * K) / K) * H;
      for (int c = T.tid; c < H; c += tb::WG_THREADS) {
        float sum = 0.f;
        for (int i = 0; i < per; ++i) sum += T.red[(q * per + i) * 256 + c];
        out[c] = sum;
      }
    }
  }
  if (!p.order1) {
    T.sync();
    const int q = T.tid;
    if (q < tb::ROWS / K && row0 + q * K < p.S) {
      float sum = 0.f;
      for (int k = 0; k < K; ++k) sum += arow[q * K + k];
      p.alpha[(row0 + q * K) / K] = sum;
    }
  }
}

__global__ void __launch_bounds__(tb::THREADS, 1)
trunk_fwd_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = tb::align1024(smem_raw);
  wg::Ring ring;
  ring.buf = base;
  ring.nst = p.nst;
  ring.stage_bytes = wg::MAX_STAGE;
  unsigned char* abuf0 = base + (size_t)p.nst * wg::MAX_STAGE;
  float* vec = reinterpret_cast<float*>(abuf0 + (size_t)2 * p.maxa *
                                                    wg::TILE_PANEL);
  tb::PeCol* pe_tab = reinterpret_cast<tb::PeCol*>(vec + 5 * tb::VEC);
  float* red0 = reinterpret_cast<float*>(pe_tab + tb::PE_COLS);
  float* rows0 = red0 + 2 * 1024;
  ring.full = reinterpret_cast<uint64_t*>(rows0 + 2 * 128);
  ring.empty = ring.full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.nst; ++s) {
      wg::mbar_init(&ring.full[s], 1);
      wg::mbar_init(&ring.empty[s], 2);
    }
    wg::mbar_fence_init();
  }
  tb::load_vecs(vec, p.b, p.N, p.nl, p.order1 ? nullptr : p.wa, p.H3);
  tb::load_pe_table(pe_tab, p.Fe, p.nf, p.nd, p.C1);
  __syncthreads();
  if (threadIdx.x >= 2 * tb::WG_THREADS) {   // the producer warpgroup
    wg::reg_dealloc<tb::PRODUCER_REGS>();
    if (threadIdx.x == 2 * tb::WG_THREADS)
      tb::produce(ring, p.img, p.seq, p.nl, p.tiles);
    return;
  }
  wg::reg_alloc<tb::CONSUMER_REGS>();
  Tile T = tb::make_tile(&ring, abuf0, p.maxa, red0);
  float* wrow = rows0 + T.wgi * 128;
  float* arow = wrow + 64;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * 2 * tb::ROWS + T.wgi * tb::ROWS;
    T.sync();   // the previous tile's reads of wrow, arow and red
    if (T.tid < tb::ROWS)
      wrow[T.tid] = row0 + T.tid < p.S ? p.w[row0 + T.tid] : 0.f;
    tb::build_x0(T, pe_tab, p.emb, p.Fe, p.d, p.dd, row0, p.S, p.C1);
    wg::fence_async();
    T.sync();
    for (int li = 0; li < p.nl; ++li) {
      if (li == p.L1) {   // block3's input [h, ex3]
        tb::fill_ex3(T, p.ex3, p.E3, p.H1, row0, p.S);
        wg::fence_async();
        T.sync();
      }
      if (li < p.nl - 1)
        hidden(T, p, li, vec);
      else
        last(T, p, li, row0, wrow, arow, vec);
    }
  }
}

size_t images_bytes(int C1, int H1, int E3, int H3, int L1, int L3) {
  return wg::image_bytes(C1) + (L1 == 2 ? wg::image_bytes(H1) : 0) +
         wg::image_bytes(H1 + E3) + (L3 == 2 ? wg::image_bytes(H3) : 0);
}

}  // namespace

// Floats of the workspace trunk_fwd_bf16 takes for the weight images (and
// the slack that aligns them to 1024 bytes).
extern "C" long long trunk_fwd_bf16_workspace(int C1, int H1, int E3, int H3,
                                              int L1, int L3) {
  return (long long)((images_bytes(C1, H1, E3, H3, L1, L3) + 1024) / 4);
}

// Converts the weights into their images in ws (ws_floats floats,
// trunk_fwd_bf16_workspace's count), then runs the trunk; the arguments
// are trunk_fwd's. Returns cudaGetLastError() after the launches (0 =
// launched; cudaErrorInvalidValue: widths the kernel does not take).
extern "C" int trunk_fwd_bf16(const float* emb, const float* d,
                              const float* ex3, const float* w,
                              const float* w1, const float* b1,
                              const float* w12, const float* b12,
                              const float* w3, const float* b3,
                              const float* w32, const float* b32,
                              const float* wa, const float* ba, float* feat,
                              float* alpha, float* ws, long long ws_floats,
                              int S, int Fe, int dd, int E3, int nf, int nd,
                              int H1, int H3, int L1, int L3, int K,
                              int act_super, int order1, void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w;
  p.wa = wa; p.ba = ba; p.feat = feat; p.alpha = alpha;
  p.S = S; p.Fe = Fe; p.dd = dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  p.C1 = Fe + 2 * nf * Fe + 2 * nd * dd;
  const int X3 = H1 + E3;
  p.maxa = max(max(wg::panels(p.C1), wg::panels(X3)), 4);
  p.nst = tb::fit_stages(p.maxa, EXTRA, MAX_STAGES);
  if (H1 > 256 || H3 > 256 || H1 <= 0 || H3 <= 0 || K < 1 || 64 % K ||
      p.nst < 2 ||
      trunk_fwd_bf16_workspace(p.C1, H1, E3, H3, L1, L3) > ws_floats)
    return (int)cudaErrorInvalidValue;
  unsigned char* at = reinterpret_cast<unsigned char*>(
      ((uintptr_t)ws + 1023) & ~(uintptr_t)1023);
  wg::ConvertJob job{};
  const float* wsrc[4] = {w1, w12, w3, w32};
  const float* bias[4] = {b1, b12, b3, b32};
  const int Kin[4] = {p.C1, H1, X3, H3}, Nout[4] = {H1, H1, H3, H3};
  const bool used[4] = {true, L1 == 2, true, L3 == 2};
  p.nl = 0;
  for (int m = 0; m < 4; ++m) {
    if (!used[m]) continue;
    const int li = p.nl++;
    p.img[li] = wg::add_image(job, wsrc[m], Kin[m], Nout[m], at);
    p.b[li] = bias[m];
    p.N[li] = Nout[m];
    p.seq[li] = li;
  }
  const size_t smem = tb::smem_bytes(p.nst, p.maxa, EXTRA);
  cudaFuncSetAttribute(trunk_fwd_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  p.tiles = (S + 2 * tb::ROWS - 1) / (2 * tb::ROWS);
  if (p.tiles <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = wg::launch_convert(job, st);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(p.tiles, tb::sm_count());
  trunk_fwd_bf16_kernel<<<grid, tb::THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}
