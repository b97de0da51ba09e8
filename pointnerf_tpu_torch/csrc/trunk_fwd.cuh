// The fused trunk's forward on one 64-row tile, shared by csrc/trunk_fwd.cu
// (K1, whose header comment gives the design) and csrc/shade_fwd.cu (K4,
// which computes the tile's inputs in the kernel first).
//
// Per neighbor row r of the tile:
//   x  = [emb, PE(emb), PE(d)]           PE column order channel → freq → (sin, cos)
//   h  = block1(x)                       1-2 LeakyReLU(0.1) layers
//   g  = block3([h, ex3])                1-2 LeakyReLU(0.1) layers
//   a  = softplus(g·wa + ba − 1)         (relu without act_super; order 2 only)
// then per shading point, feat[p] = Σ_k w·g and alpha[p] = Σ_k w·a.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // rows per block (multiple of every supported K)
constexpr int THREADS = 256;  // 8 warps
constexpr int RPW = 8;        // rows per warp: 8 warps x 8 = 64
constexpr int CPL = 8;        // columns per lane: 32 lanes x 8 = 256 max width
constexpr int KC = 16;        // weight rows per staged chunk
constexpr float HALF_PI = 1.57079637050628662109375f;  // float32(pi/2)

struct Params {
  const float *emb, *d, *ex3, *w;     // d, ex3, w: K1's row inputs
  const float *w1, *b1, *w12, *b12;   // w1 [C1, H1] = [w1e; w1p; w1d]
  const float *w3, *b3, *w32, *b32;   // w3 [H1 + E3, H3] = [w3x; w3e]
  const float *wa, *ba;               // [H3], [1]
  float *feat, *alpha;                // [S/K, H3], [S/K]
  int S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, K, act_super, order1;
  int C1, ld;                         // first-layer width, smem row stride
};

// Fills p.C1 and p.ld; returns the bytes of shared memory trunk_tile uses.
inline size_t setup(Params& p) {
  p.C1 = p.Fe + 2 * p.nf * p.Fe + 2 * p.nd * p.dd;
  int ld = p.C1;
  if (p.H1 + p.E3 > ld) ld = p.H1 + p.E3;
  if (p.H3 > ld) ld = p.H3;
  p.ld = (ld + 3) & ~3;   // 16-byte aligned rows for the float4 reads
  const int hmax = p.H1 > p.H3 ? p.H1 : p.H3;
  return (size_t)(2 * TILE * p.ld + 2 * KC * hmax + 2 * TILE) * sizeof(float);
}

// The tile's shared memory: two activation buffers, the weight chunks, the
// rows' neighbor weights and activated alphas. A kernel's own shared
// arrays start at `end`.
struct Smem {
  float *buf0, *buf1, *ws, *wrow, *arow, *end;
};

__device__ __forceinline__ Smem smem_layout(const Params& p, float* smem) {
  Smem s;
  s.buf0 = smem;
  s.buf1 = s.buf0 + TILE * p.ld;
  s.ws = s.buf1 + TILE * p.ld;      // [2, KC, max(H1, H3)] weight chunks
  s.wrow = s.ws + 2 * KC * max(p.H1, p.H3);  // [TILE] neighbor weights
  s.arow = s.wrow + TILE;           // [TILE] activated alpha per row
  s.end = s.arow + TILE;
  return s;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.1f * x; }

// Copy W rows [k0, k0 + rows) of a [cin, H] matrix into dst [KC, H] with
// 16-byte asynchronous copies (H % 4 == 0; the wrapper checks), as one
// commit group.
__device__ __forceinline__ void stage_rows(const float* __restrict__ W, int k0,
                                           int rows, int H, float* dst) {
  const int n4 = rows * H / 4;
  const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * H);
  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[r, c] = act(Σ_k in[r, k] W[k, c] + b[c]) for the block's 64 rows.
// `in` rows are 16-byte aligned (ld is a multiple of 4). W streams through
// `ws` (2 x KC rows, double-buffered): chunk c+1 is in flight while chunk c
// is multiplied, so the inner loop reads shared memory only.
__device__ void dense(const float* in, int cin, const float* __restrict__ W,
                      const float* __restrict__ b, int H, float* out, int ld,
                      bool act, float* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
  const float* x = in + warp * RPW * ld;
  const int nchunks = (cin + KC - 1) / KC;
  stage_rows(W, 0, min(KC, cin), H, ws);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * KC, kn = min(KC, cin - k0);
    if (ch + 1 < nchunks) {
      stage_rows(W, k0 + KC, min(KC, cin - k0 - KC), H,
                 ws + ((ch + 1) & 1) * KC * H);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* wc = ws + (ch & 1) * KC * H;
    if (kn == KC) {
#pragma unroll
      for (int k4 = 0; k4 < KC; k4 += 4) {
        float4 xv[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          xv[i] = *reinterpret_cast<const float4*>(x + i * ld + k0 + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float wv[CPL];
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = lane + 32 * j;
            wv[j] = c < H ? wc[(k4 + kk) * H + c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float xs = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                           : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
            for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(xs, wv[j], acc[i][j]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) {
        float wv[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          wv[j] = c < H ? wc[kk * H + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float xs = x[i * ld + k0 + kk];
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(xs, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();   // chunk ch's buffer is refilled two chunks later
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < H) {
      const float bc = __ldg(b + c);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float v = acc[i][j] + bc;
        out[(warp * RPW + i) * ld + c] = act ? leaky(v) : v;
      }
    }
  }
}

// PE column j of a D-channel input with F frequencies: channel j/(2F),
// frequency (j/2)%F, sin for even j and cos (= sin(t + pi/2)) for odd j.
__device__ __forceinline__ float pe_value(const float* row, int j, int F) {
  const int ch = j / (2 * F), f = (j >> 1) % F;
  const float t = __fadd_rn(__fmul_rn(row[ch], (float)(1 << f)),
                            (j & 1) ? HALF_PI : 0.f);
  return sinf(t);
}

// The trunk of the tile whose first row is row0. Row r of the tile reads
// its distances at d_t[r·dd] and its ex3 at ex3_t[r·E3] (global or shared
// memory; read for rows < S only) and its neighbor weight at s.wrow[r],
// which the caller writes before the call (0 past S). Writes feat and
// alpha of the tile's shading points.
__device__ __forceinline__ void trunk_tile(const Params& p, int row0,
                                           const float* d_t,
                                           const float* ex3_t,
                                           const Smem& s) {
  const int pe_e = 2 * p.nf * p.Fe;

  // first-layer input [emb, PE(emb), PE(d)] into buf0; rows past S are zero
  for (int idx = threadIdx.x; idx < TILE * p.C1; idx += THREADS) {
    const int r = idx / p.C1, c = idx - r * p.C1, g = row0 + r;
    float v = 0.f;
    if (g < p.S) {
      const float* e = p.emb + (size_t)g * p.Fe;
      if (c < p.Fe) v = e[c];
      else if (c < p.Fe + pe_e) v = pe_value(e, c - p.Fe, p.nf);
      else v = pe_value(d_t + r * p.dd, c - p.Fe - pe_e, p.nd);
    }
    s.buf0[r * p.ld + c] = v;
  }
  __syncthreads();

  float* cur = s.buf0;
  float* nxt = s.buf1;
  dense(cur, p.C1, p.w1, p.b1, p.H1, nxt, p.ld, true, s.ws);
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }
  if (p.L1 == 2) {
    dense(cur, p.H1, p.w12, p.b12, p.H1, nxt, p.ld, true, s.ws);
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  // park ex3 beside h: block3's input row is [h, ex3]
  for (int idx = threadIdx.x; idx < TILE * p.E3; idx += THREADS) {
    const int r = idx / p.E3, c = idx - r * p.E3, g = row0 + r;
    cur[r * p.ld + p.H1 + c] = g < p.S ? ex3_t[r * p.E3 + c] : 0.f;
  }
  __syncthreads();
  dense(cur, p.H1 + p.E3, p.w3, p.b3, p.H3, nxt, p.ld, true, s.ws);
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }
  if (p.L3 == 2) {
    dense(cur, p.H3, p.w32, p.b32, p.H3, nxt, p.ld, true, s.ws);
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }

  if (!p.order1) {
    // alpha head per row: warp-wide dot product, then the density activation
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float sum = 0.f;
      for (int k = lane; k < p.H3; k += 32) sum = fmaf(cur[r * p.ld + k], __ldg(p.wa + k), sum);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float za = sum + __ldg(p.ba);
        s.arow[r] = p.act_super ? fmaxf(za - 1.f, 0.f) + log1pf(expf(-fabsf(za - 1.f)))
                                : fmaxf(za, 0.f);
      }
    }
    __syncthreads();
  }

  // weighted K-sum per shading point; a point exists iff its first row < S
  const int npts = TILE / p.K;
  const int pt0 = row0 / p.K;
  for (int idx = threadIdx.x; idx < npts * p.H3; idx += THREADS) {
    const int q = idx / p.H3, c = idx - q * p.H3;
    if (row0 + q * p.K >= p.S) continue;
    float sum = 0.f;
    for (int k = 0; k < p.K; ++k) {
      const int r = q * p.K + k;
      sum = fmaf(s.wrow[r], cur[r * p.ld + c], sum);
    }
    p.feat[(size_t)(pt0 + q) * p.H3 + c] = sum;
  }
  if (!p.order1 && threadIdx.x < npts && row0 + threadIdx.x * p.K < p.S) {
    const int q = threadIdx.x;
    float sum = 0.f;
    for (int k = 0; k < p.K; ++k) sum = fmaf(s.wrow[q * p.K + k], s.arow[q * p.K + k], sum);
    p.alpha[pt0 + q] = sum;
  }
}

}  // namespace
