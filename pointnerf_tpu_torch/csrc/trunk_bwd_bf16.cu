// Fused per-neighbor shading trunk, backward, with bfloat16 product
// operands (Hopper: wgmma on bf16 shared-memory tiles fed by bulk copies).
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
// What bounds it: ≈3 x 271k multiply-adds a row at lego widths, one bf16
// tensor-core product each (989 TFLOP/s dense: 0.079 / 0.158 ms at the
// train step's 48,000 / 96,000 rows), plus the scratch between the two
// phases: each layer's input X and gated cotangent dz in bf16 (≈2,200
// values a row with the panels' padding), written once and read back
// once for X and once per pair of 64-column panels of X for dz.
//
// Design (csrc/trunk_bf16.cuh, csrc/bf16_wgmma.cuh).
// - Phase 1, trunk_bwd_bf16_kernel: K1b's block (a persistent grid over
//   128-row tiles, two consumer warpgroups of 64 rows, a producer
//   warpgroup streaming the weights' bf16 images by bulk copies through
//   an mbarrier ring of three stages). It recomputes the forward as K1b
//   does, then chains dz·Wᵀ back on wgmma with dz from registers (its A
//   fragments) and the same weight image read MN-major through the
//   descriptor (no separate Wᵀ), m64n64k16 over 16 slices for each
//   64-column chunk of the output.
//   - Each layer input X (the A panels before the layer's product) and
//     each gated dz go to the scratch as bf16 by bulk stores of the panels
//     themselves (the products' layout), which halves the fp32 scratch.
//   - The LeakyReLU gates are the signs of the fp32 pre-activations z,
//     kept as ballot bits in shared memory when the forward's epilogue
//     writes each layer's output (z >= 0, as JAX's _dleaky: a tiny
//     negative z whose bf16 rounding is -0.0 takes the 0.1 slope, as in
//     JAX); the last layer's gate reads z in registers.
//   - The bias gradients are fp32 column sums of the unrounded dz, the
//     alpha head's rows Σ bf(g)·bf(dza) and Σ dza likewise: per 64-row
//     unit in a fixed order (a thread's two rows, a butterfly over a
//     warp, the four warps in order), then over the units in a fixed
//     order (reduce_cols).
//   - dx0's PE part is rounded (bf(dx·cos), cos by cosf's own fast path as
//     in K1b) into the A panels, whose values are exact in bf16, and
//     summed per channel in column order; the emb part is fp32 and goes
//     to demb first.
// - Phase 2, wgrad_bf16_kernel: dW_l = Xᵀ·dz over all rows, split over
//   the 64-row units: a block takes 128 rows of dW (one per warpgroup) by
//   all 256 columns over one split, both operands MN-major bulk copies of
//   the scratch panels; the partials are summed in split order
//   (reduce_splits).
// - No float atomics: two runs give bit-identical gradients.

#include <cuda_runtime.h>
#include <math.h>

#include "trunk_bf16.cuh"

namespace {

using tb::Tile;

constexpr int MAX_STAGES = 3;                  // phase 1's ring
constexpr int GATE_WORDS = 3 * 512;            // ballots of 3 layers a warpgroup
// after the A panels and the vectors: red [2][1024], rows [2][128] (wrow,
// dza), gates [2][GATE_WORDS], barriers
constexpr size_t EXTRA =
    2 * 1024 * 4 + 2 * 128 * 4 + 2 * GATE_WORDS * 4 + 2 * 8 * 8;

// phase 2: a stage holds two 64-row X panels and up to four dz panels
constexpr int W_STAGE = 6 * wg::TILE_PANEL;
constexpr int W_STAGES = 4;
constexpr int W_SMEM = 1024 + W_STAGES * W_STAGE + 2 * W_STAGES * 8;
constexpr int MAX_JOBS = 16;

struct Params {
  const float *emb, *d, *ex3, *w, *dfeat, *dalpha, *wa, *ba;
  wg::Image img[4];          // w1, (w12), w3, (w32)
  const float* b[4];
  int N[4], Kin[4];          // output and input widths
  int seq[8];                // a tile's chunk order: forward, then backward
  unsigned char *X[4], *D[4];   // scratch: [U][panels][64-row panel]
  float* colpart;            // [U][ncols]: db of each layer, dwa, dba
  int cb[4], c_wa, c_ba, ncols;
  float *demb, *dd, *dex3, *dw;
  int nl, S, Fe, Dd, E3, nf, nd, H1, H3, L1, K, act_super, order1, C1, X3;
  int tiles, nst, maxa;
};

// A layer before the last: X's store has been issued; the product, then
// the output in place with its gate bits.
__device__ __forceinline__ void hidden(Tile& T, const Params& p, int li,
                                       const float* vec, uint32_t* gates) {
  float acc[tb::ACC];
  tb::product_ss(acc, T, p.img[li]);
  if (T.tid == 0) wg::bulk_wait_read();   // X's store has read the panels
  T.sync();
  tb::store_leaky(acc, T, vec + li * tb::VEC, gates + li * 512);
  wg::fence_async();
  T.sync();
}

// The last layer: the product, then dw, the alpha head's rows, dz of the
// last layer (gated by its z) with its bias sums, dz into the A panels.
__device__ __forceinline__ void last(Tile& T, const Params& p, int li, int u,
                                     int row0, const float* wrow,
                                     float* dzrow, const float* vec) {
  constexpr int NB = 256;
  float acc[tb::ACC];
  tb::product_ss(acc, T, p.img[li]);
  if (T.tid == 0) wg::bulk_wait_read();
  const float* b = vec + li * tb::VEC;
  const float* wa = vec + 4 * tb::VEC;
  const int H = p.H3, t = T.t;
  float* part = p.colpart + (size_t)u * p.ncols;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {   // z = acc + b: 0 past H
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] += bb.x;
      acc[4 * j + 2 * h + 1] += bb.y;
    }
  }
  bool valid[2];
  const float* df[2];   // the rows' dfeat (a valid row's; masked below)
  float w_h[2], da[2], dza[2] = {0.f, 0.f}, act[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + T.row(h);
    valid[h] = row < p.S;
    const int prow = valid[h] ? row / p.K : 0;
    df[h] = p.dfeat + (size_t)prow * H;
    w_h[h] = wrow[T.row(h)];
    da[h] = !p.order1 && valid[h] ? p.dalpha[prow] : 0.f;
  }
  // dfeat of column c (and c + 1) of row h: 0 past H and on rows past S
  auto dfeat2 = [&](int h, int c) {
    const float2 f = *reinterpret_cast<const float2*>(df[h] + min(c, H - 2));
    const bool in = valid[h] && c < H;
    return make_float2(in ? f.x : 0.f, in ? f.y : 0.f);
  };
  if (!p.order1) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const float2 ww = *reinterpret_cast<const float2*>(wa + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] = fmaf(wg::rn(tb::leaky(acc[4 * j + 2 * h])), ww.x, s[h]);
        s[h] = fmaf(wg::rn(tb::leaky(acc[4 * j + 2 * h + 1])), ww.y, s[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      const float za = s[h] + __ldg(p.ba);
      float dact;
      if (p.act_super) {
        const float x = za - 1.f;
        act[h] = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        dact = 1.f / (1.f + expf(-x));
      } else {
        act[h] = fmaxf(za, 0.f);
        dact = za >= 0.f ? 1.f : 0.f;
      }
      dza[h] = valid[h] ? da[h] * w_h[h] * dact : 0.f;
      if (t == 0) dzrow[T.row(h)] = dza[h];
    }
  }
  if (!p.order1) {
    // the unit's row of the head's gradient: Σ_r bf(g)·bf(dza), Σ_r dza
    const float rzh[2] = {wg::rn(dza[0]), wg::rn(dza[1])};
#pragma unroll
    for (int q = 0; q < NB / 64; ++q) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        v[i] = wg::rn(tb::leaky(acc[32 * q + i])) * rzh[(i >> 1) & 1];
      tb::colsum<8>(T, v, part + p.c_wa, 64 * q, H);
    }
    if (T.tid == 0) {   // dzrow is complete: colsum's barriers
      float s = 0.f;
      for (int r = 0; r < tb::ROWS; ++r) s += dzrow[r];
      part[p.c_ba] = s;
    }
  }
  // one pass over dfeat, 8 of its loads in flight at a time: dw = Σ
  // g·dfeat (+ act·dalpha), and dz = dg · (z >= 0 ? 1 : 0.1) with dg =
  // dfeat·w + bf(dza)·bf(wa), 0 past H and on rows past S
  constexpr int JB = 4;
  float sf[2] = {0.f, 0.f};
  const float rz[2] = {wg::rn(dza[0]), wg::rn(dza[1])};
#pragma unroll
  for (int j0 = 0; j0 < NB / 8; j0 += JB) {
    float2 f[JB][2];
#pragma unroll
    for (int j = 0; j < JB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) f[j][h] = dfeat2(h, 8 * (j0 + j) + 2 * t);
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const float2 ww =
          *reinterpret_cast<const float2*>(wa + 8 * (j0 + j) + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& z0 = acc[4 * (j0 + j) + 2 * h];
        float& z1 = acc[4 * (j0 + j) + 2 * h + 1];
        sf[h] = fmaf(tb::leaky(z0), f[j][h].x, sf[h]);
        sf[h] = fmaf(tb::leaky(z1), f[j][h].y, sf[h]);
        const float g0 = fmaf(rz[h], ww.x, f[j][h].x * w_h[h]);
        const float g1 = fmaf(rz[h], ww.y, f[j][h].y * w_h[h]);
        z0 = g0 * (z0 >= 0.f ? 1.f : tb::NEG_SLOPE);
        z1 = g1 * (z1 >= 0.f ? 1.f : tb::NEG_SLOPE);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sf[h] += __shfl_xor_sync(0xffffffffu, sf[h], 1);
    sf[h] += __shfl_xor_sync(0xffffffffu, sf[h], 2);
    if (t == 0 && valid[h])
      p.dw[row0 + T.row(h)] = p.order1 ? sf[h] : sf[h] + act[h] * da[h];
  }
#pragma unroll
  for (int q = 0; q < NB / 64; ++q)   // dz's column sums, in place
    tb::colsum<8>(T, *reinterpret_cast<const float(*)[32]>(acc + 32 * q),
                  part + p.cb[li], 64 * q, H);
  // X's store has been read (thread 0 waited before colsum's barriers)
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *T.word(T.row(h), 8 * j + 2 * t) =
          wg::pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  wg::fence_async();
  T.sync();
}

// One step of the backward chain, for layer li with dz in the A panels:
// store dz, take it as A fragments, dx = dz·Wᵀ chunk by chunk; gate dx
// into dz of the layer before (its bias sums, dex3 at block3's first
// layer) or, at the first layer, demb and dd.
__device__ __forceinline__ void back_layer(Tile& T, const Params& p, int li,
                                           int u, int row0,
                                           const uint32_t* gates,
                                           const tb::PeCol* tab) {
  uint32_t a[16][4];
  float* part = p.colpart + (size_t)u * p.ncols;
  const int t = T.t;
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) valid[h] = row0 + T.row(h) < p.S;
  if (T.tid == 0)
    wg::bulk_store(p.D[li] + (size_t)u * 4 * wg::TILE_PANEL, T.abuf,
                   4 * wg::TILE_PANEL);
  tb::load_afrag(T, a);
  if (T.tid == 0) wg::bulk_wait_read();
  T.sync();   // the fragments are loaded and dz stored: the panels are free
  if (li > 0) {
    const int prev = li - 1, Np = p.N[prev];
    const uint32_t* gw = gates + prev * 512 + T.warp * 128;
    const bool block3 = li == p.L1;
    tb::product_rs(T, p.img[li], a, [&](int c, float (&v)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 64 * c + 8 * j + 2 * t + e;
            float& x = v[4 * j + 2 * h + e];
            if (block3 && col >= Np && col < p.X3 && valid[h])
              p.dex3[(size_t)(row0 + T.row(h)) * p.E3 + col - Np] = x;
            if (col < Np) {
              const uint32_t bits = gw[4 * (8 * c + j) + 2 * h + e];
              x = (bits >> T.lane) & 1u ? x : tb::NEG_SLOPE * x;
            } else {
              x = 0.f;
            }
          }
      tb::colsum<8>(T, v, part + p.cb[prev], 64 * c, Np);
      if (c < wg::panels(Np)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *T.word(T.row(h), 64 * c + 8 * j + 2 * t) =
                wg::pack(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      }
    });
    wg::fence_async();
    T.sync();
  } else {
    // dx0: the emb columns to demb, the PE columns as bf(dx·cos) into the
    // panels (exact bf16 values), then each channel's sum
    const int Fe = p.Fe, pe_e = 2 * p.nf * Fe, C1 = p.C1;
    tb::product_rs(T, p.img[0], a, [&](int c, float (&v)[32]) {
      // each PE entry's input first (loads in flight together), then
      // bf(dx·cos) and the stores
      float xin[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int cc = 64 * c + 8 * (i >> 2) + 2 * t + (i & 1);
        const tb::PeCol m = tab[cc];
        xin[i] = valid[h] && tb::pe_col(m)
                     ? __ldg(tb::pe_src(m, p.emb, Fe, p.d, p.Dd,
                                        row0 + T.row(h)))
                     : 0.f;
      }
      // bf(dx·cos) of every PE entry, branch-free (cosf's own reduction
      // only past its fast path's range); 0 on the emb columns
      bool big = false;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cc = 64 * c + 8 * (i >> 2) + 2 * t + (i & 1);
        const tb::PeCol m = tab[cc];
        const float arg = tb::pe_arg(m, xin[i]);
        big |= tb::pe_col(m) && fabsf(arg) >= tb::TRIG_FAST;
        const float cs = tb::trig_fast(arg, 1);
        xin[i] = tb::pe_col(m) ? wg::rn(__fmul_rn(v[i], cs)) : 0.f;
      }
      if (big) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int cc = 64 * c + 8 * (i >> 2) + 2 * t + (i & 1);
          const tb::PeCol m = tab[cc];
          if (!valid[h] || !tb::pe_col(m)) continue;
          const float arg = tb::pe_arg(
              m, __ldg(tb::pe_src(m, p.emb, Fe, p.d, p.Dd, row0 + T.row(h))));
          if (fabsf(arg) >= tb::TRIG_FAST)
            xin[i] = wg::rn(__fmul_rn(v[i], cosf(arg)));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 64 * c + 8 * j + 2 * t;
          const int row = row0 + T.row(h);
          if (!valid[h] || col >= C1) continue;
          float uu[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            if (col + e < Fe) p.demb[(size_t)row * Fe + col + e] = v[i];
            uu[e] = xin[i];
          }
          *T.word(T.row(h), col) = wg::pack(uu[0], uu[1]);
        }
    });
    T.sync();   // the panels' PE values and demb's emb part are written
    // each channel's sum of bf(dx·cos)·2^f over its columns, in order
    const int nch = Fe + p.Dd;
    for (int i = T.tid; i < tb::ROWS * nch; i += tb::WG_THREADS) {
      const int r = i / nch, ch = i - r * nch, row = row0 + r;
      if (row >= p.S) continue;
      const bool fe = ch < Fe;
      const int F = fe ? p.nf : p.nd;
      const int c0 = fe ? Fe + 2 * p.nf * ch : Fe + pe_e + 2 * p.nd * (ch - Fe);
      float sum = 0.f;
      for (int k = 0; k < 2 * F; ++k) {
        const float val = __uint_as_float(
            (uint32_t)*reinterpret_cast<const unsigned short*>(
                T.abuf + wg::swz(r, c0 + k, tb::ROWS))
            << 16);
        sum = fmaf(val, (float)(1 << tab[c0 + k].f), sum);
      }
      if (fe) {
        float* o = p.demb + (size_t)row * Fe + ch;
        *o = *o + sum;
      } else {
        p.dd[(size_t)row * p.Dd + ch - Fe] = sum;
      }
    }
  }
}

// Phase 1: per 128-row tile, the forward recompute (each layer input to
// the scratch), dw, the head's and the biases' unit rows, dz of each layer
// to the scratch, demb, dd and dex3.
__global__ void __launch_bounds__(tb::THREADS, 1)
trunk_bwd_bf16_kernel(const __grid_constant__ Params p) {
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
  uint32_t* gates0 = reinterpret_cast<uint32_t*>(rows0 + 2 * 128);
  ring.full = reinterpret_cast<uint64_t*>(gates0 + 2 * GATE_WORDS);
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
      tb::produce(ring, p.img, p.seq, 2 * p.nl, p.tiles);
    return;
  }
  wg::reg_alloc<tb::CONSUMER_REGS>();
  Tile T = tb::make_tile(&ring, abuf0, p.maxa, red0);
  float* wrow = rows0 + T.wgi * 128;
  float* dzrow = wrow + 64;
  uint32_t* gates = gates0 + T.wgi * GATE_WORDS;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int u = 2 * tile + T.wgi, row0 = u * tb::ROWS;
    T.sync();   // the previous tile's reads of wrow, dzrow and the panels
    if (T.tid < tb::ROWS)
      wrow[T.tid] = row0 + T.tid < p.S ? p.w[row0 + T.tid] : 0.f;
    tb::build_x0(T, pe_tab, p.emb, p.Fe, p.d, p.Dd, row0, p.S, p.C1);
    wg::fence_async();
    T.sync();
    for (int li = 0; li < p.nl; ++li) {
      if (li == p.L1) {   // block3's input [h, ex3]
        tb::fill_ex3(T, p.ex3, p.E3, p.H1, row0, p.S);
        wg::fence_async();
        T.sync();
      }
      const int atx = wg::panels(p.Kin[li]);
      if (T.tid == 0)
        wg::bulk_store(p.X[li] + (size_t)u * atx * wg::TILE_PANEL, T.abuf,
                       atx * wg::TILE_PANEL);
      if (li < p.nl - 1)
        hidden(T, p, li, vec, gates);
      else
        last(T, p, li, u, row0, wrow, dzrow, vec);
    }
    for (int li = p.nl - 1; li >= 0; --li)   // the backward chain
      back_layer(T, p, li, u, row0, gates, pe_tab);
  }
  if (T.tid == 0) wg::bulk_wait();
}

// ------------------------------------------------------------------ phase 2
struct WgradParams {
  const unsigned char* X[4];
  const unsigned char* D[4];
  int atx[4], M[4], N[4], o_w[4];
  int job_l[MAX_JOBS], job_a[MAX_JOBS];   // a job's layer and first panel
  int U, per_split, pstride;             // pstride: floats per partial
  float* partial;                         // [nsplit][pstride]
};

// acc = Σ over the split's units of X[:, panel]ᵀ·dz, for the warpgroup's
// 64 rows of dW; then into the split's partial.
__device__ __forceinline__ void wgrad_run(const wg::Ring& ring,
                                          const WgradParams& wp, int li,
                                          int a, bool active, int n) {
  constexpr int NB = 256;
  float acc[tb::ACC];
  const int tid = threadIdx.x % tb::WG_THREADS, wgi = threadIdx.x / 128;
  // both warpgroups multiply (the second on a stale panel where the job
  // has one), so the products stay in straight-line code
  for (int k = 0; k < n; ++k) {
    ring.wait_full(k);
    unsigned char* st = ring.stage(k);
    const uint32_t xa = wg::smem_u32(st + wgi * wg::TILE_PANEL);
    const uint32_t db = wg::smem_u32(st + 2 * wg::TILE_PANEL);
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wg::mma256<1, 1>(acc, wg::desc_mn(xa + 2048 * s, wg::TILE_PANEL),
                       wg::desc_mn(db + 2048 * s, wg::TILE_PANEL),
                       k > 0 || s > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    if (tid == 0) ring.release(k);
  }
  if (!active) return;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int M = wp.M[li], N = wp.N[li];
  float* out = wp.partial + (size_t)blockIdx.y * wp.pstride + wp.o_w[li];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * a + warp * 16 + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < N) {
        const float v0 = n > 0 ? acc[4 * j + 2 * h] : 0.f;
        const float v1 = n > 0 ? acc[4 * j + 2 * h + 1] : 0.f;
        *reinterpret_cast<float2*>(out + (size_t)m * N + c) =
            make_float2(v0, v1);
      }
    }
  }
}

__global__ void __launch_bounds__(tb::THREADS, 1)
wgrad_bf16_kernel(const __grid_constant__ WgradParams wp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = tb::align1024(smem_raw);
  wg::Ring ring;
  ring.buf = base;
  ring.nst = W_STAGES;
  ring.stage_bytes = W_STAGE;
  ring.full = reinterpret_cast<uint64_t*>(base + W_STAGES * W_STAGE);
  ring.empty = ring.full + W_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      wg::mbar_init(&ring.full[s], 1);
      wg::mbar_init(&ring.empty[s], 2);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int li = wp.job_l[blockIdx.x], a0 = wp.job_a[blockIdx.x];
  const bool two = a0 + 1 < wp.atx[li];
  const int u0 = blockIdx.y * wp.per_split;
  const int n = max(0, min(wp.U, u0 + wp.per_split) - u0);
  const int atx = wp.atx[li];
  if (threadIdx.x >= 2 * tb::WG_THREADS) {   // the producer warpgroup
    wg::reg_dealloc<tb::PRODUCER_REGS>();
    if (threadIdx.x == 2 * tb::WG_THREADS) {
      const uint32_t xb = (two ? 2 : 1) * wg::TILE_PANEL;
      const uint32_t zb = 4 * wg::TILE_PANEL;   // dz: 4 panels
      for (int k = 0; k < n; ++k) {
        const size_t u = (size_t)(u0 + k);
        ring.wait_empty(k);
        uint64_t* bar = &ring.full[k % W_STAGES];
        unsigned char* st = ring.stage(k);
        wg::mbar_expect(bar, xb + zb);
        wg::bulk_load(st, wp.X[li] + (u * atx + a0) * wg::TILE_PANEL, xb,
                      bar);
        wg::bulk_load(st + 2 * wg::TILE_PANEL,
                      wp.D[li] + u * zb, zb, bar);
      }
    }
    return;
  }
  wg::reg_alloc<tb::CONSUMER_REGS>();
  const int wgi = threadIdx.x / tb::WG_THREADS;
  const bool active = wgi == 0 || two;
  wgrad_run(ring, wp, li, a0 + wgi, active, n);
}

// The weights' entries of dW: out[o + e] = Σ_s part[s·pstride + o + e] over
// the splits in order, for each layer's (o, len).
struct Segs {
  int off[4], len[4], n, total;
};

__global__ void reduce_splits(const float* __restrict__ part, int nsplit,
                              int pstride, Segs sg, float* __restrict__ out) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= sg.total) return;
  int i = 0;
  while (e >= sg.len[i]) e -= sg.len[i++];
  const int o = sg.off[i] + e;
  float s = 0.f;
  for (int q = 0; q < nsplit; ++q) s += part[(size_t)q * pstride + o];
  out[o] = s;
}

// The column sums: out[dst(c)] = Σ_u colpart[u·ncols + c] over the units,
// each of 8 lanes of a column summing units ≡ lane (mod 8) in order, then
// a fixed tree. Columns [cbase[i], cbase[i] + len[i]) go to dst[i] on.
struct ColMap {
  int cbase[6], len[6], dst[6], n;
};

__global__ void __launch_bounds__(256)
reduce_cols(const float* __restrict__ colpart, int U, int ncols, ColMap cm,
            float* __restrict__ out) {
  __shared__ float sm[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < ncols)
    for (int u = ty; u < U; u += 8) s += colpart[(size_t)u * ncols + c];
  sm[ty][tx] = s;
  __syncthreads();
  for (int w = 4; w > 0; w >>= 1) {
    if (ty < w) sm[ty][tx] += sm[ty + w][tx];
    __syncthreads();
  }
  if (ty == 0 && c < ncols) {
    for (int i = 0; i < cm.n; ++i)
      if (c >= cm.cbase[i] && c < cm.cbase[i] + cm.len[i])
        out[cm.dst[i] + c - cm.cbase[i]] = sm[0][tx];
  }
}

// The flat dW layout (trunk_bwd's): offsets of each layer's weight and
// bias, the head's wa (ba follows it).
struct Layout {
  int o_w[4], o_b[4], o_wa;
};

struct Plan {
  wg::ConvertJob job;
  Params p;
  WgradParams wp;
  Segs segs;
  ColMap cm;
  int jobs, nsplit, U;
  size_t bytes;      // workspace bytes from a 1024-aligned start
};

// Lays out the workspace from `at` (nullptr: only count it): the weight
// images, the scratch panels, the unit rows of column sums, the split
// partials.
inline Plan plan(int S, int Fe, int Dd, int E3, int nf, int nd, int H1,
                 int H3, int L1, int L3, int order1, int sms,
                 unsigned char* at, const float* const* wsrc) {
  Plan pl{};
  Params& p = pl.p;
  p.S = S; p.Fe = Fe; p.Dd = Dd; p.E3 = E3; p.nf = nf; p.nd = nd;
  p.H1 = H1; p.H3 = H3; p.L1 = L1; p.order1 = order1;
  p.C1 = Fe + 2 * nf * Fe + 2 * nd * Dd;
  p.X3 = H1 + E3;
  p.tiles = (S + 2 * tb::ROWS - 1) / (2 * tb::ROWS);
  pl.U = 2 * p.tiles;
  size_t off = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* r = at ? at + off : nullptr;
    off += (bytes + 1023) & ~(size_t)1023;
    return r;
  };
  const int Kin[4] = {p.C1, H1, p.X3, H3}, Nout[4] = {H1, H1, H3, H3};
  const bool used[4] = {true, L1 == 2, true, L3 == 2};
  Layout lay{};
  int o = 0;
  p.nl = 0;
  int ncols = 0;
  for (int m = 0; m < 4; ++m) {
    if (!used[m]) continue;
    const int li = p.nl++;
    lay.o_w[li] = o; o += Kin[m] * Nout[m];
    lay.o_b[li] = o; o += Nout[m];
    p.N[li] = Nout[m];
    p.Kin[li] = Kin[m];
    p.cb[li] = ncols;
    ncols += Nout[m];
    unsigned char* im = carve(wg::image_bytes(Kin[m]));
    unsigned char* cur = im;
    if (at) {
      p.img[li] = wg::add_image(pl.job, wsrc[m], Kin[m], Nout[m], cur);
    } else {
      p.img[li].chunks = wg::panels(Kin[m]);
    }
  }
  lay.o_wa = o;
  p.c_wa = ncols;
  p.c_ba = ncols + H3;
  if (!order1) ncols += H3 + 1;
  p.ncols = ncols;
  for (int li = 0; li < p.nl; ++li) {
    p.seq[li] = li;
    p.seq[p.nl + li] = p.nl - 1 - li;
    p.X[li] = carve((size_t)pl.U * wg::panels(p.Kin[li]) * wg::TILE_PANEL);
    p.D[li] = carve((size_t)pl.U * 4 * wg::TILE_PANEL);
  }
  p.colpart = reinterpret_cast<float*>(carve((size_t)pl.U * ncols * 4));
  // phase 2's jobs: two panels of a layer's input each
  WgradParams& wp = pl.wp;
  pl.jobs = 0;
  for (int li = 0; li < p.nl; ++li) {
    wp.X[li] = p.X[li];
    wp.D[li] = p.D[li];
    wp.atx[li] = wg::panels(p.Kin[li]);
    wp.M[li] = p.Kin[li];
    wp.N[li] = p.N[li];
    wp.o_w[li] = lay.o_w[li];
    for (int a = 0; a < wp.atx[li]; a += 2) {
      wp.job_l[pl.jobs] = li;
      wp.job_a[pl.jobs] = a;
      ++pl.jobs;
    }
  }
  int ns = sms / pl.jobs;
  if (ns > pl.U / 4) ns = pl.U / 4;
  pl.nsplit = ns > 1 ? ns : 1;
  wp.U = pl.U;
  wp.per_split = (pl.U + pl.nsplit - 1) / pl.nsplit;
  // the partial of split s holds layer li's dW at s·o_wa + o_w[li]
  wp.pstride = lay.o_wa;
  pl.segs.n = p.nl;
  pl.segs.total = 0;
  for (int li = 0; li < p.nl; ++li) {
    pl.segs.off[li] = lay.o_w[li];
    pl.segs.len[li] = p.Kin[li] * p.N[li];
    pl.segs.total += pl.segs.len[li];
  }
  wp.partial = reinterpret_cast<float*>(
      carve((size_t)pl.nsplit * lay.o_wa * 4));
  ColMap& cm = pl.cm;
  cm.n = 0;
  for (int li = 0; li < p.nl; ++li) {
    cm.cbase[cm.n] = p.cb[li];
    cm.len[cm.n] = p.N[li];
    cm.dst[cm.n++] = lay.o_b[li];
  }
  if (!order1) {
    cm.cbase[cm.n] = p.c_wa;
    cm.len[cm.n] = H3 + 1;     // wa, then ba: consecutive in dW too
    cm.dst[cm.n++] = lay.o_wa;
  }
  pl.bytes = off;
  return pl;
}

}  // namespace

// Floats of the workspace trunk_bwd_bf16 takes (weight images, scratch
// panels, column-sum rows, split partials) for S rows of widths Fe, Dd,
// E3, with the slack that aligns it to 1024 bytes.
extern "C" long long trunk_bwd_bf16_workspace(int S, int Fe, int Dd, int E3,
                                              int nf, int nd, int H1, int H3,
                                              int L1, int L3, int order1) {
  const Plan pl = plan(S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3, order1,
                       tb::sm_count(), nullptr, nullptr);
  return (long long)((pl.bytes + 1024) / 4);
}

// The arguments and the flat dweights layout are trunk_bwd's; ws holds
// ws_floats floats (trunk_bwd_bf16_workspace's count). Returns
// cudaGetLastError() after the launches (0 = launched;
// cudaErrorInvalidValue: widths the kernels do not take).
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
  const int C1 = Fe + 2 * nf * Fe + 2 * nd * Dd;
  if (H1 > 256 || H3 > 256 || H1 <= 0 || H3 <= 0 || H1 % 4 || H3 % 4 ||
      wg::panels(C1) > tb::MAX_RS_CHUNKS ||
      wg::panels(H1 + E3) > tb::MAX_RS_CHUNKS || K < 1 || 64 % K ||
      trunk_bwd_bf16_workspace(S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3,
                               order1) > ws_floats)
    return (int)cudaErrorInvalidValue;
  unsigned char* at = reinterpret_cast<unsigned char*>(
      ((uintptr_t)ws + 1023) & ~(uintptr_t)1023);
  const float* wsrc[4] = {w1, w12, w3, w32};
  Plan pl = plan(S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3, order1,
                 tb::sm_count(), at, wsrc);
  Params& p = pl.p;
  p.emb = emb; p.d = d; p.ex3 = ex3; p.w = w; p.dfeat = dfeat;
  p.dalpha = dalpha; p.wa = wa; p.ba = ba;
  p.demb = demb; p.dd = dd; p.dex3 = dex3; p.dw = dw;
  p.K = K; p.act_super = act_super;
  const float* bias[4] = {b1, b12, b3, b32};
  for (int m = 0, li = 0; m < 4; ++m)
    if (m == 0 || m == 2 || (m == 1 && L1 == 2) || (m == 3 && L3 == 2))
      p.b[li++] = bias[m];
  p.maxa = max(max(wg::panels(C1), wg::panels(p.X3)), 4);
  p.nst = tb::fit_stages(p.maxa, EXTRA, MAX_STAGES);
  if (p.nst < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = tb::smem_bytes(p.nst, p.maxa, EXTRA);
  cudaFuncSetAttribute(trunk_bwd_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(wgrad_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = wg::launch_convert(pl.job, st);
  if (err != cudaSuccess) return (int)err;
  trunk_bwd_bf16_kernel<<<min(p.tiles, tb::sm_count()), tb::THREADS, smem,
                          st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_bf16_kernel<<<dim3(pl.jobs, pl.nsplit), tb::THREADS, W_SMEM, st>>>(
      pl.wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_splits<<<(pl.segs.total + 255) / 256, 256, 0, st>>>(
      pl.wp.partial, pl.nsplit, pl.wp.pstride, pl.segs, dweights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_cols<<<(p.ncols + 31) / 32, 256, 0, st>>>(p.colpart, pl.U, p.ncols,
                                                   pl.cm, dweights);
  return (int)cudaGetLastError();
}
