// The fused trunk's backward, shared by csrc/trunk_bwd.cu (K2, whose header
// comment gives the design) and csrc/shade_bwd.cu (K5, which computes the
// tile's inputs in the kernel first and turns its per-row cotangents into
// the per-attribute ones after).
//
// Phase 1, per 32-row tile (trunk_bwd_tile): recompute the forward of
// trunk_fwd.cuh,
//   x0 = [emb, PE(emb), PE(d)],  h = block1(x0),  g = block3([h, ex3]),
//   za = g·wa + ba (order 2),
// then chain the per-shading-point cotangents back: dfeat and dalpha are
// un-grouped to the K rows of each point, and
//   dw  = g·dfeat + act(za)·dalpha
//   dza = dalpha·w·act'(za),  dg = dfeat·w + dza·waᵀ
// go back through block3 and block1 (LeakyReLU(0.1) gates read off the sign
// of each layer's output) to demb, dd (through the PE sines) and dex3. Each
// layer's input X and gated cotangent dz go to a scratch in device memory,
// already split into TF32 hi and lo planes, and the tile's alpha-head
// gradient (Σ_r g·dza, Σ_r dza) to its own row of `head`.
// Phase 2 (launch_wgrad): dW = Xᵀ·dz and db = Σ_r dz of every layer over
// all rows, a split-K tensor-core product (wgrad_kernel), its split
// partials and the tiles' head rows summed in a fixed order.
// Every product is mma.sync TF32 in the 3xTF32 split (tf32_mma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"
#include "trunk_pe.cuh"

namespace {

constexpr int TILE = 32;                 // rows per phase-1 tile
constexpr int MIN_BLOCKS = 2;            // blocks an SM holds (76 KB of
                                         // shared memory, <= 128 registers
                                         // a thread each): two 32-row
                                         // blocks ran K2 faster than one
                                         // 64-row block
constexpr int THREADS = tf32::GEMM_THREADS;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = TILE / NWARPS;       // rows per warp in the row loops
constexpr int NT = 9;                    // n-tiles per warp: one pass of a
                                         // product up to 288 wide
constexpr int MAX_N = 32 * NT;           // widest product (in place: one pass)
constexpr int KC = 8;                    // weight rows per staged chunk
constexpr float NEG_SLOPE = 0.1f;

// phase 2: a block computes BM rows of one layer's dW (all of its N <= BN
// columns) over one split of the rows, in chunks of KR rows
constexpr int BM = 64, BN = 256, KR = 16;
constexpr int LDA2 = BM + 8, LDB2 = BN + 8;   // ≡ 8 (mod 32)
constexpr int WG_STAGE = 2 * KR * (LDA2 + LDB2);   // hi and lo planes
constexpr int WG_SMEM = 2 * WG_STAGE * (int)sizeof(float);

// One layer's weight gradient for phase 2: dW [M, N] = Xᵀ·D over the rows,
// into the flat dW at o_w, its bias gradient Σ_r D at o_b. X and D are
// kept as TF32 hi and lo planes.
struct WLayer {
  float *Xh, *Xl, *Dh, *Dl;   // [S, ldx] x 2, [S, N] x 2
  int ldx, M, N, o_w, o_b;
};

struct Params {
  const float *emb, *d, *ex3, *w, *dfeat, *dalpha;  // d, ex3, w: K2's rows
  const float *b1, *b12, *b3, *b32, *wa, *ba;
  tf32::Mat m1, m12, m3, m32;          // split weights (forward recompute)
  tf32::Mat t1, t12, t3, t32;          // split transposes (dz·Wᵀ)
  float *demb, *dd, *dex3, *dw;        // dd, dex3, dw: K2's outputs
  WLayer wl[4];                        // w1, (w12), w3, (w32): scratch
  float* head;                         // [tiles, H3 + 1] alpha-head rows
  int S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, X3, ld, nW, nl;
  // offsets of each layer's gradient in the flat dW layout
  int o_w1, o_b1, o_w12, o_b12, o_w3, o_b3, o_w32, o_b32, o_wa, o_ba;
};

// Fills the widths, the row stride and the dW offsets of p; returns the
// bytes of shared memory trunk_bwd_tile uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.Dd;
  p.X3 = p.H1 + p.E3;
  int w = tf32::round8(p.C1);
  if (tf32::round8(p.X3) > w) w = tf32::round8(p.X3);
  if (tf32::round8(p.H1) > w) w = tf32::round8(p.H1);
  if (tf32::round8(p.H3) > w) w = tf32::round8(p.H3);
  p.ld = tf32::stride_mod32(w, 4);   // conflict-free A fragments
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
  p.o_ba = off; off += p.order1 ? 0 : 1;
  p.nW = off;
  return (size_t)(TILE * p.ld + tf32::ws_floats(NT, KC) + 2 * TILE) *
         sizeof(float);
}

// What the launches after phase 1 need.
struct Plan {
  tf32::SplitJob job;
  float* partial;     // [nsplit, o_wa]
  int nsplit, jobs, tiles, rows_per_split;
  size_t floats;      // workspace floats
};

// Lays the workspace out (weights' planes, the scratch, the head rows, the
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
  float* sp = carve(tf32::split_floats(p.C1, p.H1) * 2
                    + (p.L1 == 2 ? tf32::split_floats(p.H1, p.H1) * 2 : 0)
                    + tf32::split_floats(p.X3, p.H3) * 2
                    + (p.L3 == 2 ? tf32::split_floats(p.H3, p.H3) * 2 : 0));
  if (ws) {
    p.m1 = tf32::add_split(pl.job, w1, p.C1, p.H1, false, sp);
    p.t1 = tf32::add_split(pl.job, w1, p.C1, p.H1, true, sp);
    if (p.L1 == 2) {
      p.m12 = tf32::add_split(pl.job, w12, p.H1, p.H1, false, sp);
      p.t12 = tf32::add_split(pl.job, w12, p.H1, p.H1, true, sp);
    }
    p.m3 = tf32::add_split(pl.job, w3, p.X3, p.H3, false, sp);
    p.t3 = tf32::add_split(pl.job, w3, p.X3, p.H3, true, sp);
    if (p.L3 == 2) {
      p.m32 = tf32::add_split(pl.job, w32, p.H3, p.H3, false, sp);
      p.t32 = tf32::add_split(pl.job, w32, p.H3, p.H3, true, sp);
    }
  }
  const size_t S = (size_t)p.S;
  auto layer = [&](int M, int N, int o_w, int o_b) {
    WLayer l;
    l.ldx = tf32::round4(M);
    l.M = M; l.N = N; l.o_w = o_w; l.o_b = o_b;
    l.Xh = carve(S * l.ldx);
    l.Xl = carve(S * l.ldx);
    l.Dh = carve(S * N);
    l.Dl = carve(S * N);
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

// The tile's shared memory: one activation buffer (every product runs in
// place), the weight chunks, the rows' neighbor weights and alpha
// pre-activation gradients. A kernel's own shared arrays start at `end`.
struct Smem {
  float *buf, *ws, *wrow, *dza, *end;
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.buf = smem;                         // [TILE, ld]
  s.ws = s.buf + TILE * p.ld;           // 2 stages x (hi, lo) weight chunks
  s.wrow = s.ws + tf32::ws_floats(NT, KC);   // [TILE] neighbor weights
  s.dza = s.wrow + TILE;                // [TILE] alpha pre-activation grads
  s.end = s.dza + TILE;
  return s;
}

// Where one tile's per-row inputs and outputs live: row r of the tile at
// r·Dd, r·E3, r (global or shared memory).
struct Tile {
  const float *d, *ex3;     // [TILE, Dd], [TILE, E3]
  float *dd, *dex3, *dw;    // [TILE, Dd], [TILE, E3], [TILE]
};

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : NEG_SLOPE * x; }
__device__ __forceinline__ float gate(float h) { return h >= 0.f ? 1.f : NEG_SLOPE; }

// buf[r, n] = leaky(Σ_k buf[r, k] W[k, n] + b[n]) for n < W.np (0 past H),
// in place: the products read buf before the epilogue writes it.
__device__ __forceinline__ void gemm_leaky(float* buf, const tf32::Mat& W,
                                           const float* __restrict__ b, int H,
                                           int ld, float* ws) {
  tf32::tile_gemm<TILE, NT, KC, true>(
      buf, ld, W, ws, [&](int r, int n, float v0, float v1) {
        float2 o;
        o.x = n < H ? leaky(v0 + __ldg(b + n)) : 0.f;
        o.y = n + 1 < H ? leaky(v1 + __ldg(b + n + 1)) : 0.f;
        *reinterpret_cast<float2*>(buf + r * ld + n) = o;
      });
}

// buf[r, n] = acc · gate(act[r, n]) for n < gcols, acc for gcols <= n < N,
// 0 past N, with acc = Σ_k buf[r, k] W[k, n], in place. act is the layer
// output the gate reads, the hi plane of a layer input in the scratch
// ([S, ald], rows of the tile from row0; the TF32 rounding keeps signs).
__device__ __forceinline__ void gemm_gate(float* buf, const tf32::Mat& W,
                                          int N, int gcols,
                                          const float* __restrict__ act,
                                          int ald, int row0, int S, int ld,
                                          float* ws) {
  tf32::tile_gemm<TILE, NT, KC, true>(
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
// [S, cols] scratch as TF32 hi and lo planes (cols a multiple of 4).
__device__ __forceinline__ void store_split(const float* src, int ld,
                                            float* hi, float* lo, int cols,
                                            int row0, int S) {
  const int q = cols >> 2;
  for (int i = threadIdx.x; i < TILE * q; i += THREADS) {
    const int r = i / q, c4 = (i - r * q) * 4;
    if (row0 + r >= S) continue;
    const float4 v = *reinterpret_cast<const float4*>(src + r * ld + c4);
    uint32_t h[4], l[4];
    tf32::split(v.x, h[0], l[0]);
    tf32::split(v.y, h[1], l[1]);
    tf32::split(v.z, h[2], l[2]);
    tf32::split(v.w, h[3], l[3]);
    const size_t o = (size_t)(row0 + r) * cols + c4;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Phase 1 of tile `tile`. Row r reads its d and ex3 from t.d, t.ex3 and its
// neighbor weight from s.wrow[r], which the caller writes before the call;
// the row's dd, dex3 and dw go to t.dd, t.dex3, t.dw, its demb to p.demb,
// its layer inputs and gated cotangents to the scratch (rows < S only).
// Ends with a barrier, after which every shared buffer may be reused.
__device__ __forceinline__ void trunk_bwd_tile(const Params& p, int tile,
                                               const Tile& t, const Smem& s) {
  const int ld = p.ld, row0 = tile * TILE, S = p.S;
  float* buf = s.buf;
  float* ws = s.ws;
  float* wrow = s.wrow;
  float* dza = s.dza;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pe_e = 2 * p.nf * p.Fe;
  const WLayer& l1 = p.wl[0];
  const WLayer& l12 = p.wl[1];
  const WLayer& l3 = p.wl[p.L1 == 2 ? 2 : 1];
  const WLayer& l32 = p.wl[p.L1 == 2 ? 3 : 2];

  // ---- forward recompute, in place; each layer's input to the scratch
  pe::build_x0<TILE, THREADS>(p.emb, p.Fe, t.d, p.Dd, p.nf, p.nd, row0, S,
                              p.C1, p.m1.kp, buf, ld);
  __syncthreads();
  store_split(buf, ld, l1.Xh, l1.Xl, l1.ldx, row0, S);
  gemm_leaky(buf, p.m1, p.b1, p.H1, ld, ws);
  if (p.L1 == 2) {
    store_split(buf, ld, l12.Xh, l12.Xl, l12.ldx, row0, S);
    gemm_leaky(buf, p.m12, p.b12, p.H1, ld, ws);
  }
  const int e3p = p.m3.kp - p.H1;     // [h, ex3], zero-padded
  for (int idx = threadIdx.x; idx < TILE * e3p; idx += THREADS) {
    const int r = idx / e3p, c = idx - r * e3p, g = row0 + r;
    buf[r * ld + p.H1 + c] = g < S && c < p.E3 ? t.ex3[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  store_split(buf, ld, l3.Xh, l3.Xl, l3.ldx, row0, S);
  gemm_leaky(buf, p.m3, p.b3, p.H3, ld, ws);
  if (p.L3 == 2) {
    store_split(buf, ld, l32.Xh, l32.Xl, l32.ldx, row0, S);
    gemm_leaky(buf, p.m32, p.b32, p.H3, ld, ws);
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
      if (!p.order1) sa = fmaf(gv, __ldg(p.wa + c), sa);
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
        dz = da * wrow[r] * dact;
      }
      if (valid) t.dw[r] = dwv;
      dza[r] = dz;
    }
  }
  __syncthreads();
  if (!p.order1) {
    // the tile's row of the alpha head's gradient: Σ_r g·dza, Σ_r dza
    float* hrow = p.head + (size_t)tile * (p.H3 + 1);
    for (int c = threadIdx.x; c < p.H3; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r) sum = fmaf(buf[r * ld + c], dza[r], sum);
      hrow[c] = sum;
    }
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r) sum += dza[r];
      hrow[p.H3] = sum;
    }
    __syncthreads();
  }

  // ---- dg = dfeat·w + dza·waᵀ, gated by g into the last block3 layer's dz
  for (int idx = threadIdx.x; idx < TILE * p.H3; idx += THREADS) {
    const int r = idx / p.H3, c = idx - r * p.H3, row = row0 + r;
    float v = 0.f;
    if (row < S) {
      v = p.dfeat[(size_t)(row / p.K) * p.H3 + c] * wrow[r];
      if (!p.order1) v = fmaf(dza[r], __ldg(p.wa + c), v);
    }
    buf[r * ld + c] = v * gate(buf[r * ld + c]);
  }
  __syncthreads();
  if (p.L3 == 2) {     // dz3 = dz32·w32ᵀ, gated by g1 (w32's input)
    store_split(buf, ld, l32.Dh, l32.Dl, l32.N, row0, S);
    gemm_gate(buf, p.t32, p.H3, p.H3, l32.Xh, l32.ldx, row0, S, ld, ws);
  }

  // ---- block3's first layer: [dh | dex3] = dz3·w3ᵀ, dh gated by h
  store_split(buf, ld, l3.Dh, l3.Dl, l3.N, row0, S);
  gemm_gate(buf, p.t3, p.X3, p.H1, l3.Xh, l3.ldx, row0, S, ld, ws);
  for (int idx = threadIdx.x; idx < TILE * p.E3; idx += THREADS) {
    const int r = idx / p.E3, c = idx - r * p.E3, row = row0 + r;
    if (row < S) t.dex3[r * p.E3 + c] = buf[r * ld + p.H1 + c];
  }
  if (p.L1 == 2) {     // dz1 = dz12·w12ᵀ, gated by h1 (w12's input)
    store_split(buf, ld, l12.Dh, l12.Dl, l12.N, row0, S);
    gemm_gate(buf, p.t12, p.H1, p.H1, l12.Xh, l12.ldx, row0, S, ld, ws);
  }

  // ---- block1's first layer: dx0 = dz1·w1ᵀ
  store_split(buf, ld, l1.Dh, l1.Dl, l1.N, row0, S);
  gemm_gate(buf, p.t1, p.C1, 0, nullptr, 0, row0, S, ld, ws);

  // ---- demb = dx0[emb] + Σ dx0[PE(emb)]·cos·2^f, dd = Σ dx0[PE(d)]·cos·2^f
  const int nch = p.Fe + p.Dd;
  for (int idx = threadIdx.x; idx < TILE * nch; idx += THREADS) {
    const int r = idx / nch, ch = idx - r * nch, row = row0 + r;
    if (row >= S) continue;
    const float* dx = buf + r * ld;
    if (ch < p.Fe) {
      const float x = p.emb[(size_t)row * p.Fe + ch];
      float sum = 0.f;
      for (int j = 2 * p.nf * ch; j < 2 * p.nf * (ch + 1); ++j)
        sum = fmaf(dx[p.Fe + j] * cosf(pe::arg(x, j, p.nf)),
                   (float)(1 << ((j >> 1) % p.nf)), sum);
      p.demb[(size_t)row * p.Fe + ch] = dx[ch] + sum;
    } else {
      const int c = ch - p.Fe;
      const float x = t.d[r * p.Dd + c];
      float sum = 0.f;
      for (int j = 2 * p.nd * c; j < 2 * p.nd * (c + 1); ++j)
        sum = fmaf(dx[p.Fe + pe_e + j] * cosf(pe::arg(x, j, p.nd)),
                   (float)(1 << ((j >> 1) % p.nd)), sum);
      t.dd[r * p.Dd + c] = sum;
    }
  }
  __syncthreads();   // the next tile reuses every buffer
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
// X[r, m0 + m] and B(r, n) = D[r, n] are staged KR rows at a time as the
// hi and lo planes phase 1 wrote (double-buffered cp.async, rows past the
// split zero-filled), so no operand is split here. Two blocks an SM.
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(WgradParams wp) {
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

  // stage layout: Xh [KR, LDA2], Xl, Dh [KR, LDB2], Dl
  auto stage = [&](int ch) {
    float* xs = sm + (ch & 1) * WG_STAGE;
    float* ds = xs + 2 * KR * LDA2;
    const int r0 = r_begin + ch * KR;
    const int qa = bm >> 2, qb = N >> 2;
    for (int i = threadIdx.x; i < KR * (qa + qb); i += THREADS) {
      if (i < KR * qa) {
        const int r = i / qa, c4 = (i - r * qa) * 4, row = r0 + r;
        const bool in = row < r_end;
        const size_t o = in ? (size_t)row * L.ldx + m0 + c4 : 0;
        tf32::cp16(xs + r * LDA2 + c4, L.Xh + o, in ? 16 : 0);
        tf32::cp16(xs + (KR + r) * LDA2 + c4, L.Xl + o, in ? 16 : 0);
      } else {
        const int j = i - KR * qa;
        const int r = j / qb, c4 = (j - r * qb) * 4, row = r0 + r;
        const bool in = row < r_end;
        const size_t o = in ? (size_t)row * N + c4 : 0;
        tf32::cp16(ds + r * LDB2 + c4, L.Dh + o, in ? 16 : 0);
        tf32::cp16(ds + (KR + r) * LDB2 + c4, L.Dl + o, in ? 16 : 0);
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
    const float* xh = sm + (ch & 1) * WG_STAGE;
    const float* xl = xh + KR * LDA2;
    const float* dh = xl + KR * LDA2;
    const float* dl = dh + KR * LDB2;
    if (bias && threadIdx.x < N)
      for (int r = 0; r < KR; ++r)
        bsum += dh[r * LDB2 + threadIdx.x] + dl[r * LDB2 + threadIdx.x];
#pragma unroll
    for (int ks = 0; ks < KR; ks += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = (ks + t) * LDA2 + wm * 32 + 16 * i + g;
        const int os[4] = {o, o + 8, o + 4 * LDA2, o + 4 * LDA2 + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[i][e] = __float_as_uint(xh[os[e]]);
          al[i][e] = __float_as_uint(xl[os[e]]);
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        uint32_t b[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (live[j0 + q]) {
            const int o = (ks + t) * LDB2 + 8 * (wn + 4 * (j0 + q)) + g;
            b[q][0] = __float_as_uint(dh[o]);
            b[q][1] = __float_as_uint(dh[o + 4 * LDB2]);
            b[q][2] = __float_as_uint(dl[o]);
            b[q][3] = __float_as_uint(dl[o + 4 * LDB2]);
          }
        }
        tf32::mma3_group<2, 8, 4, false>(acc, acc, ah, al, b, live, j0);
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

// Phase 2 and the fixed-order sums into dweights (flat, nW floats).
inline cudaError_t launch_wgrad(const Params& p, const Plan& pl,
                                float* dweights, cudaStream_t stream) {
  WgradParams wp{};
  for (int i = 0; i < p.nl; ++i) wp.l[i] = p.wl[i];
  wp.nl = p.nl;
  wp.S = p.S;
  wp.rows_per_split = pl.rows_per_split;
  wp.pstride = p.o_wa;
  wp.partial = pl.partial;
  cudaFuncSetAttribute(wgrad_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  wgrad_kernel<<<dim3(pl.jobs, pl.nsplit), THREADS, WG_SMEM, stream>>>(wp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits<<<(p.o_wa + 255) / 256, 256, 0, stream>>>(
      pl.partial, pl.nsplit, p.o_wa, p.o_wa, dweights);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.order1) return err;
  reduce_head<<<p.H3 + 1, 256, 0, stream>>>(p.head, pl.tiles, p.H3 + 1,
                                            dweights + p.o_wa);
  return cudaGetLastError();
}

// The checks both backward kernels make before a launch: widths the
// in-place products (one pass, <= MAX_N columns) and phase 2 (N <= BN)
// take, and the workspace's size. 0 when they pass.
inline int check_plan(const Params& p, const Plan& pl, long long ws_floats) {
  if (p.H1 > BN || p.H3 > BN || p.H1 % 4 || p.H3 % 4) return 1;
  if (tf32::round8(p.C1) > MAX_N || tf32::round8(p.X3) > MAX_N) return 1;
  if ((long long)pl.floats > ws_floats) return 1;
  return 0;
}

}  // namespace
