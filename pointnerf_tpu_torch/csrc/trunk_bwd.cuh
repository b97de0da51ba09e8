// The fused trunk's backward on one 32-row tile, shared by csrc/trunk_bwd.cu
// (K2, whose header comment gives the design) and csrc/shade_bwd.cu (K5,
// which computes the tile's inputs in the kernel first and turns its
// per-row cotangents into the per-attribute ones after).
//
// Per neighbor row it recomputes the forward of trunk_fwd.cuh,
//   x0 = [emb, PE(emb), PE(d)],  h = block1(x0),  g = block3([h, ex3]),
//   za = g·wa + ba (order 2),
// then chains the per-shading-point cotangents back: dfeat and dalpha are
// un-grouped to the K rows of each point, and
//   dw  = g·dfeat + act(za)·dalpha
//   dza = dalpha·w·act'(za),  dg = dfeat·w + dza·waᵀ
// go back through block3 and block1 (LeakyReLU(0.1) gates read off the sign
// of each layer's output) to demb, dd (through the PE sines), dex3, and the
// tile's share of every weight and bias gradient.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;                 // rows per tile
constexpr int THREADS = 256;             // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = TILE / NWARPS;       // 4 rows per warp
constexpr int CPL = 8;                   // columns per lane
constexpr int NB = 32 * CPL;             // output columns per pass
constexpr int NB_WIDE = 32 * 9;          // one pass of a product up to 288
                                         // wide (9 columns per lane)
constexpr int KC = 16;                   // weight rows per staged chunk
constexpr float HALF_PI = 1.57079637050628662109375f;  // float32(pi/2)
constexpr float NEG_SLOPE = 0.1f;

struct Params {
  const float *emb, *d, *ex3, *w, *dfeat, *dalpha;  // d, ex3, w: K2's rows
  const float *w1, *b1, *w12, *b12, *w3, *b3, *w32, *b32, *wa, *ba;
  const float *w1t, *w12t, *w3t, *w32t;  // transposed, widths padded to 4
  float *demb, *dd, *dex3, *dw, *partial;  // dd, dex3, dw: K2's outputs
  int S, Fe, Dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, C1p, X3, X3p, ld, nW;
  // offsets of each layer's gradient in the flat dW layout
  int o_w1, o_b1, o_w12, o_b12, o_w3, o_b3, o_w32, o_b32, o_wa, o_ba;
};

// Fills the widths, the row stride and the dW offsets of p; returns the
// bytes of shared memory trunk_bwd_tile uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.Dd;
  p.C1p = (p.C1 + 3) & ~3;
  p.X3 = p.H1 + p.E3;
  p.X3p = (p.X3 + 3) & ~3;
  int ld = p.C1p;
  if (p.X3p > ld) ld = p.X3p;
  if (p.H3 > ld) ld = p.H3;
  if (p.H1 > ld) ld = p.H1;
  p.ld = (ld + 3) & ~3;
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
  return (size_t)(4 * TILE * p.ld + 2 * KC * NB_WIDE + 2 * TILE) *
         sizeof(float);
}

// The tile's shared memory: four activation buffers, the weight chunks,
// the rows' neighbor weights and alpha pre-activation gradients. A
// kernel's own shared arrays start at `end`.
struct Smem {
  float *bufA, *bufB, *bufC, *bufD, *ws, *wrow, *dza, *end;
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.bufA = smem;                        // h1, then dz1
  s.bufB = s.bufA + TILE * p.ld;        // h2, then dz12 (L1 = 2)
  s.bufC = s.bufB + TILE * p.ld;        // x0, g1, dz3; x0 again
  s.bufD = s.bufC + TILE * p.ld;        // g2, dz32 (L3 = 2); dx0
  s.ws = s.bufD + TILE * p.ld;          // [2, KC, NB_WIDE] weight chunks
  s.wrow = s.ws + 2 * KC * NB_WIDE;     // [TILE] neighbor weights
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

// PE sine argument of column j of a channel-major D-channel encoding with
// F frequencies: x·2^f plus pi/2 on the odd (cos) columns, as trunk_fwd.cuh.
__device__ __forceinline__ float pe_arg(float x, int j, int F) {
  const int f = (j >> 1) % F;
  return __fadd_rn(__fmul_rn(x, (float)(1 << f)), (j & 1) ? HALF_PI : 0.f);
}

// Rows [k0, k0 + rows) x columns [n0, n0 + nb) of the row-major [*, ldb]
// matrix B into dst [rows, nb], as one commit group of 16-byte async copies
// (nb, n0 and ldb are multiples of 4).
__device__ __forceinline__ void stage(const float* __restrict__ B, int ldb,
                                      int k0, int rows, int n0, int nb,
                                      float* dst) {
  const int q = nb >> 2;
  for (int i = threadIdx.x; i < rows * q; i += THREADS) {
    const int r = i / q, c4 = i - r * q;
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * nb + 4 * c4));
    const float* src = B + (size_t)(k0 + r) * ldb + n0 + 4 * c4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

enum Epi { kLeakyBias, kGate };

// For the tile's rows and n < N, with acc = Σ_k in[r, k] · B[k, n]:
//   kLeakyBias: out[r, n] = leaky(acc + bias[n])
//   kGate:      out[r, n] = acc · gate(out[r, n]) for n < gcols, else acc
// (the gate reads the activation the result overwrites). B is row-major
// [cin, ldb]; `in` must not alias `out`. Each warp owns RPW rows, each lane
// the columns lane + 32·j of a 32·C-column pass; `gemm` picks C so that
// the 264- and 284-wide products of dz·Wᵀ take one pass, not two.
template <Epi EPI, int C>
__device__ void gemm_c(const float* in, int cin, const float* __restrict__ B,
                       int ldb, int N, const float* __restrict__ bias,
                       float* out, int ld, int gcols, float* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* x = in + warp * RPW * ld;
  const int nchunks = (cin + KC - 1) / KC;
  for (int n0 = 0; n0 < N; n0 += 32 * C) {
    const int nb = min(32 * C, N - n0);
    float acc[RPW][C];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
    stage(B, ldb, 0, min(KC, cin), n0, nb, ws);
    for (int ch = 0; ch < nchunks; ++ch) {
      const int k0 = ch * KC, kn = min(KC, cin - k0);
      if (ch + 1 < nchunks) {
        stage(B, ldb, k0 + KC, min(KC, cin - k0 - KC), n0, nb,
              ws + ((ch + 1) & 1) * KC * NB_WIDE);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const float* wc = ws + (ch & 1) * KC * NB_WIDE;
      if (kn == KC) {
#pragma unroll
        for (int k4 = 0; k4 < KC; k4 += 4) {
          float4 xv[RPW];
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            xv[i] = *reinterpret_cast<const float4*>(x + i * ld + k0 + k4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float wv[C];
#pragma unroll
            for (int j = 0; j < C; ++j) {
              const int c = lane + 32 * j;
              wv[j] = c < nb ? wc[(k4 + kk) * nb + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
              const float xs = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                             : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
              for (int j = 0; j < C; ++j) acc[i][j] = fmaf(xs, wv[j], acc[i][j]);
            }
          }
        }
      } else {
        for (int kk = 0; kk < kn; ++kk) {
          float wv[C];
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const int c = lane + 32 * j;
            wv[j] = c < nb ? wc[kk * nb + c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float xs = x[i * ld + k0 + kk];
#pragma unroll
            for (int j = 0; j < C; ++j) acc[i][j] = fmaf(xs, wv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();   // chunk ch's buffer is refilled two chunks later
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      if (c < nb) {
        const int n = n0 + c;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float* o = out + (warp * RPW + i) * ld + n;
          if (EPI == kLeakyBias) *o = leaky(acc[i][j] + __ldg(bias + n));
          else *o = n < gcols ? acc[i][j] * gate(*o) : acc[i][j];
        }
      }
    }
  }
}

template <Epi EPI>
__device__ void gemm(const float* in, int cin, const float* __restrict__ B,
                     int ldb, int N, const float* __restrict__ bias,
                     float* out, int ld, int gcols, float* ws) {
  if (N > NB && N <= NB_WIDE)
    gemm_c<EPI, NB_WIDE / 32>(in, cin, B, ldb, N, bias, out, ld, gcols, ws);
  else
    gemm_c<EPI, CPL>(in, cin, B, ldb, N, bias, out, ld, gcols, ws);
}

// The tile's weight and bias gradient, into this block's partial:
//   pw[k·N + n] (+)= Σ_r X[r, k] · D[r, n]   (k < cin, n < N)
//   pb[n]       (+)= Σ_r D[r, n]
// written at the block's first tile, added to after. Each warp owns 4 rows
// k of a 32-row band, each lane the columns lane + 32·j, so every partial
// entry is read and written by the same thread at every tile. The entries
// a thread adds to are loaded before its products, so the partial's round
// trip to memory overlaps them: loaded after them, each entry's load
// stalled its store, which took 9 of the kernel's 21 ms at the wide tier.
__device__ void wgrad(const float* X, int cin, const float* D, int N, int ld,
                      float* __restrict__ pw, float* __restrict__ pb,
                      bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < N; n0 += NB) {
    for (int k0 = 4 * warp; k0 < cin; k0 += 4 * NWARPS) {
      float acc[4][CPL], old[4][CPL];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int n = n0 + lane + 32 * j;
          acc[i][j] = 0.f;
          old[i][j] = (!first && k0 + i < cin && n < N)
                          ? pw[(size_t)(k0 + i) * N + n] : 0.f;
        }
      for (int r = 0; r < TILE; ++r) {
        // columns k0..k0+3 lie inside the buffer's padded width; values
        // past cin only reach accumulators that are never stored
        const float4 xv = *reinterpret_cast<const float4*>(X + r * ld + k0);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int n = n0 + lane + 32 * j;
          const float dv = n < N ? D[r * ld + n] : 0.f;
          acc[0][j] = fmaf(xv.x, dv, acc[0][j]);
          acc[1][j] = fmaf(xv.y, dv, acc[1][j]);
          acc[2][j] = fmaf(xv.z, dv, acc[2][j]);
          acc[3][j] = fmaf(xv.w, dv, acc[3][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i >= cin) break;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int n = n0 + lane + 32 * j;
          if (n < N) pw[(size_t)(k0 + i) * N + n] = old[i][j] + acc[i][j];
        }
      }
    }
  }
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float s = 0.f;
    for (int r = 0; r < TILE; ++r) s += D[r * ld + n];
    pb[n] = first ? s : pb[n] + s;
  }
}

// x0 = [emb, PE(emb), PE(d)] of rows row0.. into buf; rows past S are zero.
__device__ void load_x0(const Params& p, int row0, const float* d_t,
                        float* buf) {
  const int pe_e = 2 * p.nf * p.Fe;
  for (int idx = threadIdx.x; idx < TILE * p.C1; idx += THREADS) {
    const int r = idx / p.C1, c = idx - r * p.C1, g = row0 + r;
    float v = 0.f;
    if (g < p.S) {
      const float* e = p.emb + (size_t)g * p.Fe;
      if (c < p.Fe) {
        v = e[c];
      } else if (c < p.Fe + pe_e) {
        const int j = c - p.Fe;
        v = sinf(pe_arg(e[j / (2 * p.nf)], j, p.nf));
      } else {
        const int j = c - p.Fe - pe_e;
        v = sinf(pe_arg(d_t[r * p.Dd + j / (2 * p.nd)], j, p.nd));
      }
    }
    buf[r * p.ld + c] = v;
  }
}

// The backward of the tile whose first row is row0 (`first`: the block's
// first tile, which writes its dW partial `part` instead of adding to it).
// Row r reads its d and ex3 from t.d, t.ex3 and its neighbor weight from
// s.wrow[r], which the caller writes before the call; the row's dd, dex3
// and dw go to t.dd, t.dex3, t.dw, its demb to p.demb (rows < S only).
// Ends with a barrier, after which every shared buffer may be reused.
__device__ __forceinline__ void trunk_bwd_tile(const Params& p, int row0,
                                               bool first, const Tile& t,
                                               const Smem& s, float* part) {
  const int ld = p.ld;
  float* bufA = s.bufA;
  float* bufB = s.bufB;
  float* bufC = s.bufC;
  float* bufD = s.bufD;
  float* ws = s.ws;
  float* wrow = s.wrow;
  float* dza = s.dza;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pe_e = 2 * p.nf * p.Fe;

  // ---- forward recompute
  load_x0(p, row0, t.d, bufC);
  __syncthreads();
  gemm<kLeakyBias>(bufC, p.C1, p.w1, p.H1, p.H1, p.b1, bufA, ld, 0, ws);
  __syncthreads();
  float* hl = bufA;                  // block3's input row [h, ex3]
  if (p.L1 == 2) {
    gemm<kLeakyBias>(bufA, p.H1, p.w12, p.H1, p.H1, p.b12, bufB, ld, 0, ws);
    __syncthreads();
    hl = bufB;
  }
  for (int idx = threadIdx.x; idx < TILE * p.E3; idx += THREADS) {
    const int r = idx / p.E3, c = idx - r * p.E3, g = row0 + r;
    hl[r * ld + p.H1 + c] = g < p.S ? t.ex3[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  gemm<kLeakyBias>(hl, p.X3, p.w3, p.H3, p.H3, p.b3, bufC, ld, 0, ws);
  __syncthreads();
  float* g = bufC;
  if (p.L3 == 2) {
    gemm<kLeakyBias>(bufC, p.H3, p.w32, p.H3, p.H3, p.b32, bufD, ld, 0, ws);
    __syncthreads();
    g = bufD;
  }

  // ---- per row: dw, and the alpha head's dza (order 2)
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i, row = row0 + r;
    const bool valid = row < p.S;
    const float* df = p.dfeat + (size_t)(valid ? row / p.K : 0) * p.H3;
    float sf = 0.f, sa = 0.f;
    for (int c = lane; c < p.H3; c += 32) {
      const float gv = g[r * ld + c];
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
    for (int c = threadIdx.x; c < p.H3; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r) sum = fmaf(g[r * ld + c], dza[r], sum);
      part[p.o_wa + c] = first ? sum : part[p.o_wa + c] + sum;
    }
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int r = 0; r < TILE; ++r) sum += dza[r];
      part[p.o_ba] = first ? sum : part[p.o_ba] + sum;
    }
    __syncthreads();
  }

  // ---- dg = dfeat·w + dza·waᵀ, gated into the last block3 layer's dz
  for (int idx = threadIdx.x; idx < TILE * p.H3; idx += THREADS) {
    const int r = idx / p.H3, c = idx - r * p.H3, row = row0 + r;
    float v = 0.f;
    if (row < p.S) {
      v = p.dfeat[(size_t)(row / p.K) * p.H3 + c] * wrow[r];
      if (!p.order1) v = fmaf(dza[r], __ldg(p.wa + c), v);
    }
    g[r * ld + c] = v * gate(g[r * ld + c]);
  }
  __syncthreads();
  float* dz3 = g;
  if (p.L3 == 2) {
    wgrad(bufC, p.H3, bufD, p.H3, ld, part + p.o_w32, part + p.o_b32, first);
    __syncthreads();
    gemm<kGate>(bufD, p.H3, p.w32t, p.H3, p.H3, nullptr, bufC, ld, p.H3, ws);
    __syncthreads();
    dz3 = bufC;
  }

  // ---- block3's first layer: dW3 over [h, ex3]; [dh | dex3] = dz3·w3ᵀ
  wgrad(hl, p.X3, dz3, p.H3, ld, part + p.o_w3, part + p.o_b3, first);
  __syncthreads();
  gemm<kGate>(dz3, p.H3, p.w3t, p.X3p, p.X3p, nullptr, hl, ld, p.H1, ws);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * p.E3; idx += THREADS) {
    const int r = idx / p.E3, c = idx - r * p.E3, row = row0 + r;
    if (row < p.S) t.dex3[r * p.E3 + c] = hl[r * ld + p.H1 + c];
  }
  float* dz1 = hl;
  if (p.L1 == 2) {
    wgrad(bufA, p.H1, bufB, p.H1, ld, part + p.o_w12, part + p.o_b12, first);
    __syncthreads();
    gemm<kGate>(bufB, p.H1, p.w12t, p.H1, p.H1, nullptr, bufA, ld, p.H1, ws);
    dz1 = bufA;
  }
  __syncthreads();

  // ---- block1's first layer over the rebuilt x0; dx0 = dz1·w1ᵀ
  load_x0(p, row0, t.d, bufC);
  __syncthreads();
  wgrad(bufC, p.C1, dz1, p.H1, ld, part + p.o_w1, part + p.o_b1, first);
  __syncthreads();
  gemm<kGate>(dz1, p.H1, p.w1t, p.C1p, p.C1p, nullptr, bufD, ld, 0, ws);
  __syncthreads();

  // ---- demb = dx0[emb] + Σ dx0[PE(emb)]·cos·2^f, dd = Σ dx0[PE(d)]·cos·2^f
  const int nch = p.Fe + p.Dd;
  for (int idx = threadIdx.x; idx < TILE * nch; idx += THREADS) {
    const int r = idx / nch, ch = idx - r * nch, row = row0 + r;
    if (row >= p.S) continue;
    const float* dx = bufD + r * ld;
    if (ch < p.Fe) {
      const float x = bufC[r * ld + ch];
      float sum = 0.f;
      for (int j = 2 * p.nf * ch; j < 2 * p.nf * (ch + 1); ++j)
        sum = fmaf(dx[p.Fe + j] * cosf(pe_arg(x, j, p.nf)),
                   (float)(1 << ((j >> 1) % p.nf)), sum);
      p.demb[(size_t)row * p.Fe + ch] = dx[ch] + sum;
    } else {
      const int c = ch - p.Fe;
      const float x = t.d[r * p.Dd + c];
      float sum = 0.f;
      for (int j = 2 * p.nd * c; j < 2 * p.nd * (c + 1); ++j)
        sum = fmaf(dx[p.Fe + pe_e + j] * cosf(pe_arg(x, j, p.nd)),
                   (float)(1 << ((j >> 1) % p.nd)), sum);
      t.dd[r * p.Dd + c] = sum;
    }
  }
  __syncthreads();   // the next tile reuses every buffer
}

// out[e] = Σ_q part[q, e] over the blocks' partials, in block order.
__global__ void reduce_partials(const float* __restrict__ part, int nparts,
                                int nW, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nW) return;
  float s = 0.f;
  for (int q = 0; q < nparts; ++q) s += part[(size_t)q * nW + e];
  out[e] = s;
}

}  // namespace
