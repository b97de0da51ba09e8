// Fused per-neighbor shading trunk, backward, with bfloat16 product
// operands (Hopper, mma.sync bf16 on the tensor cores).
//
// Replaces: pointnerf_tpu/ops/pallas_trunk.py::_bwd_kernel (:191) with
// bf16=True (_dot = _dot_bf16, :205), launched by _fused_bwd_rule
// (pallas_call :412) under --trunk_dtype bfloat16. It computes K2's
// function (csrc/trunk_bwd.cu) with JAX's rounding sites: every product of
// the recomputed forward and of the backward takes operands rounded to
// bfloat16 and sums in fp32 —
//   za = bf(g)·bf(wa) + ba,  dg = dfeat·w + bf(dza)·bf(waᵀ),
//   dx = bf(dz)·bf(Wᵀ),  dW = bf(X)ᵀ·bf(dz),  dwa = bf(g)ᵀ·bf(dza),
//   demb = dx[emb] + Σ bf(dx[PE(emb)]·cos)·2^f,  dd = Σ bf(dx[PE(d)]·cos)·2^f
// (the PE selection's entries are powers of two, exact in bf16, so the
// last two products are the rounded gradient scaled and summed). The bias
// gradients (column sums of dz), dw and the gates stay fp32, as in JAX.
//
// What bounds it: the same ≈3 x 271k multiply-adds a row as K2 at lego
// widths, one bf16 tensor-core product each (989 TFLOP/s dense), plus the
// scratch between the two phases (≈2,080 floats a row in one fp32 plane,
// half of K2's two TF32 planes: written once and read once).
//
// Design: K2's two phases (csrc/trunk_bwd.cuh) with bf16 products.
// - Phase 1, one 256-thread block per 32-row tile, two blocks an SM:
//   recompute the forward, chain the cotangents back, write demb, dd, dex3
//   and dw, and store each layer's input X and gated cotangent dz to the
//   scratch as fp32 (one plane; K2 keeps TF32 hi and lo planes). x·W and
//   dz·Wᵀ run in place on one fp32 [32, ld] shared buffer through
//   bf16::tile_gemm (csrc/bf16_mma.cuh), the weights and their transposes
//   rounded once per launch into bf16 pair planes. The LeakyReLU gates are
//   read back from the scratch's layer inputs.
// - Phase 2, wgrad_bf16_kernel: dW_l = bf(X_l)ᵀ·bf(dz_l) over all rows, a
//   split-K product (blocks of 64 rows of dW × all of its ≤256 columns
//   over a split of the rows), whose fragments pair two rows of the
//   scratch each and round them in registers; the bias gradients are the
//   fp32 column sums of dz in the first row block. The alpha head's
//   gradient is summed per tile in phase 1.
// - The split partials are summed in split order, the tiles' head rows by
//   a fixed tree: no float atomics, so two runs give bit-identical
//   gradients.
// Nothing here is tuned yet: wgmma and TMA would take the products to the
// bf16 rate, and a bf16 scratch would halve its bytes.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "trunk_pe.cuh"

namespace {

constexpr int TILE = 32;                 // rows per phase-1 tile
constexpr int MIN_BLOCKS = 2;            // blocks an SM holds (≈76 KB each)
constexpr int THREADS = bf16::GEMM_THREADS;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = TILE / NWARPS;       // rows per warp in the row loops
constexpr int NT = 9;                    // n-tiles per warp: one pass of a
                                         // product up to 288 wide
constexpr int MAX_N = 32 * NT;
constexpr int KC = 32;                   // weight rows per staged chunk
constexpr float NEG_SLOPE = 0.1f;

// phase 2: a block computes BM rows of one layer's dW (all of its N <= BN
// columns) over one split of the rows, in chunks of KR rows
constexpr int BM = 64, BN = 256, KR = 16;
constexpr int LDA2 = BM + 4, LDB2 = BN + 4;   // ≡ 4 (mod 32): the row-pair
                                              // fragment loads are
                                              // conflict-free
constexpr int WG_STAGE = KR * (LDA2 + LDB2);
constexpr int WG_SMEM = 2 * WG_STAGE * (int)sizeof(float);

// One layer's weight gradient for phase 2: dW [M, N] = Xᵀ·D over the rows,
// into the flat dW at o_w, its bias gradient Σ_r D at o_b; X [S, ldx] and
// D [S, N] fp32.
struct WLayer {
  float *X, *D;
  int ldx, M, N, o_w, o_b;
};

struct Params {
  const float *emb, *d, *ex3, *w, *dfeat, *dalpha;
  const float *b1, *b12, *b3, *b32, *wa, *ba;
  bf16::Mat m1, m12, m3, m32;          // rounded weights (forward recompute)
  bf16::Mat t1, t12, t3, t32;          // rounded transposes (dz·Wᵀ)
  float *demb, *dd, *dex3, *dw;
  WLayer wl[4];                        // w1, (w12), w3, (w32): scratch
  float* head;                         // [tiles, H3 + 1] alpha-head rows
  int S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, X3, ld, nl;
  int o_w1, o_b1, o_w12, o_b12, o_w3, o_b3, o_w32, o_b32, o_wa, o_ba;
};

// Fills the widths, the row stride and the dW offsets (trunk_bwd's flat
// layout) of p; returns the bytes of shared memory phase 1 uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.Dd;
  p.X3 = p.H1 + p.E3;
  int w = bf16::round16(p.C1);
  if (bf16::round16(p.X3) > w) w = bf16::round16(p.X3);
  if (bf16::round16(p.H1) > w) w = bf16::round16(p.H1);
  if (bf16::round16(p.H3) > w) w = bf16::round16(p.H3);
  p.ld = tf32::stride_mod32(w, 8);
  int off = 0;
  p.o_w1 = off; off += p.C1 * p.H1;
  p.o_b1 = off; off += p.H1;
  p.o_w12 = off; off += p.L1 == 2 ? p.H1 * p.H1 : 0;
  p.o_b12 = off; off += p.L1 == 2 ? p.H1 : 0;
  p.o_w3 = off; off += p.X3 * p.H3;
  p.o_b3 = off; off += p.H3;
  p.o_w32 = off; off += p.L3 == 2 ? p.H3 * p.H3 : 0;
  p.o_b32 = off; off += p.L3 == 2 ? p.H3 : 0;
  p.o_wa = off; off += p.order1 ? 0 : p.H3;
  p.o_ba = off;
  return (size_t)(TILE * p.ld + bf16::ws_words(NT, KC) + 2 * TILE) *
         sizeof(float);
}

struct Plan {
  bf16::ConvertJob job;
  float* partial;     // [nsplit, o_wa]
  int nsplit, jobs, tiles, rows_per_split;
  size_t floats;      // workspace floats
};

// Lays the workspace out (rounded weights, the scratch, the head rows, the
// split partials) from `ws` (nullptr: only count it), setting p's Mats and
// scratch layers (p must have been through setup). The split count fills
// about two blocks per SM.
inline Plan plan(Params& p, float* ws, int sms, const float* w1,
                 const float* w12, const float* w3, const float* w32) {
  Plan pl{};
  size_t off = 0;
  auto carve = [&](size_t n) {
    float* at = ws ? ws + off : nullptr;
    off += (n + 3) & ~(size_t)3;   // 16-byte aligned regions
    return at;
  };
  float* cv = carve(2 * (bf16::convert_words(p.C1, p.H1)
                         + (p.L1 == 2 ? bf16::convert_words(p.H1, p.H1) : 0)
                         + bf16::convert_words(p.X3, p.H3)
                         + (p.L3 == 2 ? bf16::convert_words(p.H3, p.H3) : 0)));
  if (ws) {
    p.m1 = bf16::add_convert(pl.job, w1, p.C1, p.H1, false, cv);
    p.t1 = bf16::add_convert(pl.job, w1, p.C1, p.H1, true, cv);
    if (p.L1 == 2) {
      p.m12 = bf16::add_convert(pl.job, w12, p.H1, p.H1, false, cv);
      p.t12 = bf16::add_convert(pl.job, w12, p.H1, p.H1, true, cv);
    }
    p.m3 = bf16::add_convert(pl.job, w3, p.X3, p.H3, false, cv);
    p.t3 = bf16::add_convert(pl.job, w3, p.X3, p.H3, true, cv);
    if (p.L3 == 2) {
      p.m32 = bf16::add_convert(pl.job, w32, p.H3, p.H3, false, cv);
      p.t32 = bf16::add_convert(pl.job, w32, p.H3, p.H3, true, cv);
    }
  }
  const size_t S = (size_t)p.S;
  auto layer = [&](int M, int N, int o_w, int o_b) {
    WLayer l;
    l.ldx = tf32::round4(M);
    l.M = M; l.N = N; l.o_w = o_w; l.o_b = o_b;
    l.X = carve(S * l.ldx);
    l.D = carve(S * N);
    return l;
  };
  p.nl = 0;
  p.wl[p.nl++] = layer(p.C1, p.H1, p.o_w1, p.o_b1);
  if (p.L1 == 2) p.wl[p.nl++] = layer(p.H1, p.H1, p.o_w12, p.o_b12);
  p.wl[p.nl++] = layer(p.X3, p.H3, p.o_w3, p.o_b3);
  if (p.L3 == 2) p.wl[p.nl++] = layer(p.H3, p.H3, p.o_w32, p.o_b32);
  pl.tiles = (p.S + TILE - 1) / TILE;
  p.head = p.order1 ? nullptr : carve((size_t)pl.tiles * (p.H3 + 1));
  pl.jobs = 0;
  for (int i = 0; i < p.nl; ++i) pl.jobs += (p.wl[i].M + BM - 1) / BM;
  int ns = (2 * sms + pl.jobs - 1) / pl.jobs;
  const int by_rows = (p.S + 1023) / 1024;   // >= 1024 rows a split
  if (ns > by_rows) ns = by_rows;
  pl.nsplit = ns > 1 ? ns : 1;
  pl.rows_per_split =
      ((p.S + pl.nsplit - 1) / pl.nsplit + KR - 1) / KR * KR;
  pl.partial = carve((size_t)pl.nsplit * p.o_wa);
  pl.floats = off;
  return pl;
}

struct Smem {
  float* buf;        // [TILE, ld]
  uint32_t* ws;      // 2 stages of weight chunks
  float *wrow, *dza; // [TILE] neighbor weights, alpha pre-activation grads
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.buf = smem;
  s.ws = reinterpret_cast<uint32_t*>(s.buf + TILE * p.ld);
  s.wrow = reinterpret_cast<float*>(s.ws + bf16::ws_words(NT, KC));
  s.dza = s.wrow + TILE;
  return s;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : NEG_SLOPE * x; }
__device__ __forceinline__ float gate(float h) { return h >= 0.f ? 1.f : NEG_SLOPE; }

// buf[r, n] = leaky(Σ_k bf(buf[r, k])·W[k, n] + b[n]) for n < W.np (0 past
// H), in place.
__device__ __forceinline__ void gemm_leaky(float* buf, const bf16::Mat& W,
                                           const float* __restrict__ b, int H,
                                           int ld, uint32_t* ws) {
  bf16::tile_gemm<TILE, NT, KC>(
      buf, ld, W, ws, [&](int r, int n, float v0, float v1) {
        float2 o;
        o.x = n < H ? leaky(v0 + __ldg(b + n)) : 0.f;
        o.y = n + 1 < H ? leaky(v1 + __ldg(b + n + 1)) : 0.f;
        *reinterpret_cast<float2*>(buf + r * ld + n) = o;
      });
}

// buf[r, n] = acc · gate(act[r, n]) for n < gcols, acc for gcols <= n < N,
// 0 past N, with acc = Σ_k bf(buf[r, k])·W[k, n], in place. act is the
// layer output the gate reads: a layer input in the scratch ([S, ald],
// rows of the tile from row0).
__device__ __forceinline__ void gemm_gate(float* buf, const bf16::Mat& W,
                                          int N, int gcols,
                                          const float* __restrict__ act,
                                          int ald, int row0, int S, int ld,
                                          uint32_t* ws) {
  bf16::tile_gemm<TILE, NT, KC>(
      buf, ld, W, ws, [&](int r, int n, float v0, float v1) {
        float g0 = 1.f, g1 = 1.f;
        if (row0 + r < S && n < gcols) {
          const float* a = act + (size_t)(row0 + r) * ald + n;
          g0 = gate(a[0]);
          if (n + 1 < gcols) g1 = gate(a[1]);
        }
        float2 o;
        o.x = n < N ? v0 * g0 : 0.f;
        o.y = n + 1 < N ? v1 * g1 : 0.f;
        *reinterpret_cast<float2*>(buf + r * ld + n) = o;
      });
}

// Rows < S of the tile's buffer, columns [0, cols), into the row-major
// [S, cols] scratch (cols a multiple of 4).
__device__ __forceinline__ void store(const float* src, int ld, float* dst,
                                      int cols, int row0, int S) {
  const int q = cols >> 2;
  for (int i = threadIdx.x; i < TILE * q; i += THREADS) {
    const int r = i / q, c4 = (i - r * q) * 4;
    if (row0 + r >= S) continue;
    *reinterpret_cast<float4*>(dst + (size_t)(row0 + r) * cols + c4) =
        *reinterpret_cast<const float4*>(src + r * ld + c4);
  }
}

// Phase 1 of one tile: the rows' demb, dd, dex3 and dw, their layer inputs
// and gated cotangents into the scratch, the tile's alpha-head row.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
trunk_bwd_bf16_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = smem_layout(p, smem);
  const int ld = p.ld, S = p.S, tile = blockIdx.x, row0 = tile * TILE;
  float* buf = s.buf;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pe_e = 2 * p.nf * p.Fe;
  const WLayer& l1 = p.wl[0];
  const WLayer& l12 = p.wl[1];
  const WLayer& l3 = p.wl[p.L1 == 2 ? 2 : 1];
  const WLayer& l32 = p.wl[p.L1 == 2 ? 3 : 2];
  const float* d_t = p.d + (size_t)row0 * p.Dd;
  const float* ex3_t = p.ex3 + (size_t)row0 * p.E3;
  if (threadIdx.x < TILE) {
    const int g = row0 + threadIdx.x;
    s.wrow[threadIdx.x] = g < S ? p.w[g] : 0.f;
  }

  // ---- forward recompute, in place; each layer's input to the scratch
  pe::build_x0<TILE, THREADS>(p.emb, p.Fe, d_t, p.Dd, p.nf, p.nd, row0, S,
                              p.C1, p.m1.kp, buf, ld);
  __syncthreads();
  store(buf, ld, l1.X, l1.ldx, row0, S);
  gemm_leaky(buf, p.m1, p.b1, p.H1, ld, s.ws);
  if (p.L1 == 2) {
    store(buf, ld, l12.X, l12.ldx, row0, S);
    gemm_leaky(buf, p.m12, p.b12, p.H1, ld, s.ws);
  }
  const int e3p = p.m3.kp - p.H1;     // [h, ex3], zero-padded
  for (int idx = threadIdx.x; idx < TILE * e3p; idx += THREADS) {
    const int r = idx / e3p, c = idx - r * e3p, g = row0 + r;
    buf[r * ld + p.H1 + c] = g < S && c < p.E3 ? ex3_t[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  store(buf, ld, l3.X, l3.ldx, row0, S);
  gemm_leaky(buf, p.m3, p.b3, p.H3, ld, s.ws);
  if (p.L3 == 2) {
    store(buf, ld, l32.X, l32.ldx, row0, S);
    gemm_leaky(buf, p.m32, p.b32, p.H3, ld, s.ws);
  }

  // ---- per row: dw, and the alpha head's dza (order 2); buf holds g
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i, row = row0 + r;
    const bool valid = row < S;
    const float* df = p.dfeat + (size_t)(valid ? row / p.K : 0) * p.H3;
    float sf = 0.f, sa = 0.f;
    for (int c = lane; c < p.H3; c += 32) {
      const float gv = buf[r * ld + c];
      if (valid) sf = fmaf(gv, df[c], sf);
      if (!p.order1) sa = fmaf(bf16::rn(gv), bf16::rn(__ldg(p.wa + c)), sa);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sf += __shfl_xor_sync(0xffffffffu, sf, o);
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
    }
    if (lane == 0) {
      float dz = 0.f, dwv = sf;
      if (valid && !p.order1) {
        const float za = sa + __ldg(p.ba);
        const float da = p.dalpha[row / p.K];
        float act, dact;
        if (p.act_super) {
          const float x = za - 1.f;
          act = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
          dact = 1.f / (1.f + expf(-x));
        } else {
          act = fmaxf(za, 0.f);
          dact = za >= 0.f ? 1.f : 0.f;
        }
        dwv = sf + act * da;
        dz = da * s.wrow[r] * dact;
      }
      if (valid) p.dw[row] = dwv;
      s.dza[r] = dz;
    }
  }
  __syncthreads();
  if (!p.order1) {
    // the tile's row of the alpha head's gradient: Σ_r bf(g)·bf(dza), Σ_r dza
    float* hrow = p.head + (size_t)tile * (p.H3 + 1);
    for (int c = threadIdx.x; c < p.H3; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r)
        sum = fmaf(bf16::rn(buf[r * ld + c]), bf16::rn(s.dza[r]), sum);
      hrow[c] = sum;
    }
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r) sum += s.dza[r];
      hrow[p.H3] = sum;
    }
    __syncthreads();
  }

  // ---- dg = dfeat·w + bf(dza)·bf(waᵀ), gated by g into the last block3
  // layer's dz
  for (int idx = threadIdx.x; idx < TILE * p.H3; idx += THREADS) {
    const int r = idx / p.H3, c = idx - r * p.H3, row = row0 + r;
    float v = 0.f;
    if (row < S) {
      v = p.dfeat[(size_t)(row / p.K) * p.H3 + c] * s.wrow[r];
      if (!p.order1) v = fmaf(bf16::rn(s.dza[r]), bf16::rn(__ldg(p.wa + c)), v);
    }
    buf[r * ld + c] = v * gate(buf[r * ld + c]);
  }
  __syncthreads();
  if (p.L3 == 2) {     // dz3 = dz32·w32ᵀ, gated by g1 (w32's input)
    store(buf, ld, l32.D, l32.N, row0, S);
    gemm_gate(buf, p.t32, p.H3, p.H3, l32.X, l32.ldx, row0, S, ld, s.ws);
  }

  // ---- block3's first layer: [dh | dex3] = dz3·w3ᵀ, dh gated by h
  store(buf, ld, l3.D, l3.N, row0, S);
  gemm_gate(buf, p.t3, p.X3, p.H1, l3.X, l3.ldx, row0, S, ld, s.ws);
  for (int idx = threadIdx.x; idx < TILE * p.E3; idx += THREADS) {
    const int r = idx / p.E3, c = idx - r * p.E3, row = row0 + r;
    if (row < S) p.dex3[(size_t)row * p.E3 + c] = buf[r * ld + p.H1 + c];
  }
  if (p.L1 == 2) {     // dz1 = dz12·w12ᵀ, gated by h1 (w12's input)
    store(buf, ld, l12.D, l12.N, row0, S);
    gemm_gate(buf, p.t12, p.H1, p.H1, l12.X, l12.ldx, row0, S, ld, s.ws);
  }

  // ---- block1's first layer: dx0 = dz1·w1ᵀ
  store(buf, ld, l1.D, l1.N, row0, S);
  gemm_gate(buf, p.t1, p.C1, 0, nullptr, 0, row0, S, ld, s.ws);

  // ---- demb = dx0[emb] + Σ bf(dx0[PE(emb)]·cos)·2^f,
  //      dd = Σ bf(dx0[PE(d)]·cos)·2^f
  const int nch = p.Fe + p.Dd;
  for (int idx = threadIdx.x; idx < TILE * nch; idx += THREADS) {
    const int r = idx / nch, ch = idx - r * nch, row = row0 + r;
    if (row >= S) continue;
    const float* dx = buf + r * ld;
    if (ch < p.Fe) {
      const float x = p.emb[(size_t)row * p.Fe + ch];
      float sum = 0.f;
      for (int j = 2 * p.nf * ch; j < 2 * p.nf * (ch + 1); ++j)
        sum = fmaf(bf16::rn(__fmul_rn(dx[p.Fe + j],
                                      cosf(pe::arg(x, j, p.nf)))),
                   (float)(1 << ((j >> 1) % p.nf)), sum);
      p.demb[(size_t)row * p.Fe + ch] = dx[ch] + sum;
    } else {
      const int c = ch - p.Fe;
      const float x = d_t[r * p.Dd + c];
      float sum = 0.f;
      for (int j = 2 * p.nd * c; j < 2 * p.nd * (c + 1); ++j)
        sum = fmaf(bf16::rn(__fmul_rn(dx[p.Fe + pe_e + j],
                                      cosf(pe::arg(x, j, p.nd)))),
                   (float)(1 << ((j >> 1) % p.nd)), sum);
      p.dd[(size_t)row * p.Dd + c] = sum;
    }
  }
}

// ------------------------------------------------------------------ phase 2
struct WgradParams {
  WLayer l[4];
  int nl, S, rows_per_split, pstride;   // pstride: floats per split partial
  float* partial;
};

// Block (job, split): rows m0 .. m0 + BM of one layer's dW and, for the
// first row block, its bias gradient, summed over the split's rows, into
// the split's partial. Warps in a 2 x 4 grid, each 32 rows of dW x the
// n-tiles wn, wn + 4, ... (8 of them up to BN = 256 columns). A(m, r) =
// X[r, m0 + m] and B(r, n) = D[r, n] are staged KR rows at a time as fp32
// (double-buffered cp.async, rows past the split zero-filled); a fragment
// register pairs rows r and r + 1 and rounds both to bf16.
__global__ void __launch_bounds__(THREADS, 2)
wgrad_bf16_kernel(WgradParams wp) {
  extern __shared__ float sm[];
  int job = blockIdx.x, li = 0;
  while (li < wp.nl && job >= (wp.l[li].M + BM - 1) / BM) {
    job -= (wp.l[li].M + BM - 1) / BM;
    ++li;
  }
  const WLayer L = wp.l[li];
  const int m0 = job * BM, bm = min(BM, L.ldx - m0), N = L.N;
  const int r_begin = blockIdx.y * wp.rows_per_split;
  const int r_end = min(wp.S, r_begin + wp.rows_per_split);
  const int nchunks = r_end > r_begin ? (r_end - r_begin + KR - 1) / KR : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int ntiles = (N + 7) >> 3;
  bool live[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) live[j] = wn + 4 * j < ntiles;
  const bool bias = job == 0;

  // stage layout: X [KR, LDA2], D [KR, LDB2]
  auto stage = [&](int ch) {
    float* xs = sm + (ch & 1) * WG_STAGE;
    float* ds = xs + KR * LDA2;
    const int r0 = r_begin + ch * KR;
    const int qa = bm >> 2, qb = N >> 2;
    for (int i = threadIdx.x; i < KR * (qa + qb); i += THREADS) {
      if (i < KR * qa) {
        const int r = i / qa, c4 = (i - r * qa) * 4, row = r0 + r;
        const bool in = row < r_end;
        const size_t o = in ? (size_t)row * L.ldx + m0 + c4 : 0;
        tf32::cp16(xs + r * LDA2 + c4, L.X + o, in ? 16 : 0);
      } else {
        const int j = i - KR * qa;
        const int r = j / qb, c4 = (j - r * qb) * 4, row = r0 + r;
        const bool in = row < r_end;
        const size_t o = in ? (size_t)row * N + c4 : 0;
        tf32::cp16(ds + r * LDB2 + c4, L.D + o, in ? 16 : 0);
      }
    }
    tf32::commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float bsum = 0.f;
  if (nchunks > 0) stage(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage(ch + 1);
      tf32::wait<1>();
    } else {
      tf32::wait<0>();
    }
    __syncthreads();
    const float* xs = sm + (ch & 1) * WG_STAGE;
    const float* ds = xs + KR * LDA2;
    if (bias && threadIdx.x < N)
      for (int r = 0; r < KR; ++r) bsum += ds[r * LDB2 + threadIdx.x];
    // one k-step of 16 rows: register e of a fragment pairs rows 2t, 2t + 1
    // (e < 2) or 2t + 8, 2t + 9
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm * 32 + 16 * i + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* x = xs + (2 * t + 8 * (e >> 1)) * LDA2 + m + 8 * (e & 1);
        a[i][e] = bf16::pack(x[0], x[LDA2]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (live[j]) {
        const float* y = ds + 2 * t * LDB2 + 8 * (wn + 4 * j) + g;
        const uint32_t b0 = bf16::pack(y[0], y[LDB2]);
        const uint32_t b1 = bf16::pack(y[8 * LDB2], y[9 * LDB2]);
#pragma unroll
        for (int i = 0; i < 2; ++i) bf16::mma(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();   // chunk ch's buffer is refilled two chunks later
  }
  float* out = wp.partial + (size_t)blockIdx.y * wp.pstride;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (live[j]) {
      const int n = 8 * (wn + 4 * j) + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm * 32 + 16 * i + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mm = m + 8 * h;
          if (mm >= L.M) continue;
          float* o = out + L.o_w + (size_t)mm * N;
          if (n < N) o[n] = acc[i][j][2 * h];
          if (n + 1 < N) o[n + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
  if (bias && threadIdx.x < N) out[L.o_b + threadIdx.x] = bsum;
}

// out[e] = Σ_s part[s·pstride + e] for e < n, over the splits in order.
__global__ void reduce_splits(const float* __restrict__ part, int nsplit,
                              int pstride, int n, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int q = 0; q < nsplit; ++q) s += part[(size_t)q * pstride + e];
  out[e] = s;
}

// out[e] = Σ_t head[t·nA + e], one block per e: each thread sums tiles
// t ≡ tid (mod 256) in order, then a fixed pairwise tree.
__global__ void __launch_bounds__(256)
reduce_head(const float* __restrict__ head, int tiles, int nA,
            float* __restrict__ out) {
  __shared__ float part[256];
  const int e = blockIdx.x;
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles; t += 256) s += head[(size_t)t * nA + e];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = part[0];
}

inline int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// Floats of the workspace trunk_bwd_bf16 takes (rounded weights, scratch,
// head rows, split partials) for S rows of widths Fe, Dd, E3.
extern "C" long long trunk_bwd_bf16_workspace(int S, int Fe, int Dd, int E3,
                                              int nf, int nd, int H1, int H3,
                                              int L1, int L3, int order1) {
  Params p{};
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.order1 = order1;
  setup(p);
  return (long long)plan(p, nullptr, sm_count(), nullptr, nullptr, nullptr,
                         nullptr).floats;
}

// The arguments and the flat dweights layout are trunk_bwd's; ws holds
// ws_floats floats (trunk_bwd_bf16_workspace's count). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int trunk_bwd_bf16(const float* emb, const float* d,
                              const float* ex3, const float* w,
                              const float* dfeat, const float* dalpha,
                              const float* w1, const float* b1,
                              const float* w12, const float* b12,
                              const float* w3, const float* b3,
                              const float* w32, const float* b32,
                              const float* wa, const float* ba, float* demb,
                              float* dd, float* dex3, float* dw, float* ws,
                              long long ws_floats, float* dweights, int S,
                              int Fe, int Dd, int E3, int nf, int nd, int H1,
                              int H3, int L1, int L3, int K, int act_super,
                              int order1, void* stream) {
  Params p{};
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w; p.dfeat = dfeat;
  p.dalpha = dalpha; p.b1 = b1; p.b12 = b12; p.b3 = b3; p.b32 = b32;
  p.wa = wa; p.ba = ba;
  p.demb = demb; p.dd = dd; p.dex3 = dex3; p.dw = dw;
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.L3 = L3; p.K = K;
  p.act_super = act_super; p.order1 = order1;
  const size_t smem = setup(p);
  const Plan pl = plan(p, ws, sm_count(), w1, w12, w3, w32);
  if (H1 > BN || H3 > BN || H1 % 4 || H3 % 4 ||
      bf16::round16(p.C1) > MAX_N || bf16::round16(p.X3) > MAX_N ||
      (long long)pl.floats > ws_floats)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(trunk_bwd_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = bf16::launch_convert(pl.job, st);
  if (err != cudaSuccess) return (int)err;
  trunk_bwd_bf16_kernel<<<pl.tiles, THREADS, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradParams wp{};
  for (int i = 0; i < p.nl; ++i) wp.l[i] = p.wl[i];
  wp.nl = p.nl;
  wp.S = p.S;
  wp.rows_per_split = pl.rows_per_split;
  wp.pstride = p.o_wa;
  wp.partial = pl.partial;
  cudaFuncSetAttribute(wgrad_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  wgrad_bf16_kernel<<<dim3(pl.jobs, pl.nsplit), THREADS, WG_SMEM, st>>>(wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_splits<<<(p.o_wa + 255) / 256, 256, 0, st>>>(
      pl.partial, pl.nsplit, p.o_wa, p.o_wa, dweights);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.order1) return (int)err;
  reduce_head<<<p.H3 + 1, 256, 0, st>>>(p.head, pl.tiles, p.H3 + 1,
                                        dweights + p.o_wa);
  return (int)cudaGetLastError();
}
