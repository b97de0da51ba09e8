// Occupancy of the dilated voxel grid along each ray, and the select of the
// first SR occupied depths (Hopper).
//
// Replaces: pointnerf_tpu/ops/query.py::mask_raypos_segmented, inner kernel
// `kern` (:122, pallas_call :144). The TPU version caches each ray's <= U
// distinct 128-voxel rows and resolves every sample with a bf16 one-hot
// [D,U]@[U,128] product, because per-sample scalar gathers were
// latency-bound there; rays past U go conservative-valid. The select that
// follows it there (`select_shading_t`: a cumsum over [B,R,D], a scatter
// over D, then campos + raydir·t of the picked depths) is folded in here.
//
// What bounds it: by bytes, the outputs (a serving group of 28,800 rays at
// SR 80 writes 30 MB of positions, mask bits and counts; the inputs are the
// rays, one broadcast depth row or the jittered [B,R,D] depths, and a byte
// of the ≈9 MB L2-resident table per in-range sample). In fact it is bound
// by instruction issue: each sample needs its position rounded exactly as
// the plain float64 `fma` rounds it (three float64 fmas and casts), a
// floor, a bounds test and the table read, before any bookkeeping.
//
// Design: one warp per ray, walking its depths in order, 32 a step. Each
// lane rebuilds its sample, floors it on the float pipe (`floor_bits`),
// tests the bounds with one unsigned compare an axis and reads the byte. A
// ballot and a popcount rank the occupied lanes after the ray's running
// count (skipped on steps with none); a lane whose rank is below SR writes
// its position and mask bit to that slot. The warp stops once SR samples
// are found and fills the slots past the count with 0. Broadcast depths
// (strides 0, 0, 1) are staged once a block in shared memory as float64.
// The modes are template arguments, so the loop carries no runtime test of
// them. Indices are 32-bit (the wrapper
// refuses shapes of 2^31 elements or more). No atomics: every output is
// deterministic.
//
// Mask mode (no select outputs) writes only the [B,R,D] mask, the contract
// of `mask_raypos_segmented`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                   // rays a block, a warp each
constexpr int STAGE_MAX = 48 * 1024 / 8;   // depths a block stages at most
constexpr float FLOOR_BIAS = 12582912.0f;  // 1.5 * 2^23
constexpr unsigned FLOOR_BITS = 0x4B400000u;  // its bit pattern

struct Params {
  const float *campos, *raydir, *tvals;  // [B,3], [B,R,3], strided [B,R,D]
  const int8_t* occ;                     // dilated occupancy, row-major volume
  float* loc;                            // [B,R,SR,3]; null in mask mode
  uint8_t* smask;                        // [B,R,SR] bool
  int* counts;                           // [B,R]
  uint8_t* valid;                        // [B,R,D] bool; mask mode only
  int tsb, tsr, tsd;                     // tvals element strides
  int B, R, D, SR;
  float mn[3], inv[3];                   // ranges_min, 1/scaled_vsize
  int vdim[3];
};

// floor(x) on the float pipe: adding 1.5 * 2^23 rounded down leaves floor(x)
// in the low mantissa bits, exactly for |x| < 2^22. Outside that range, and
// for NaN, the result is no index in [0, 2^22), so one unsigned compare
// against vdim <= 2^22 (the wrapper checks it) is the bounds test. floorf,
// the float to int conversion and two float compares would take four
// instructions, two of them on the slower conversion pipe.
__device__ __forceinline__ unsigned floor_bits(float x) {
  return __float_as_uint(__fadd_rd(x, FLOOR_BIAS)) - FLOOR_BITS;
}

// Sample d of the ray: its position, rounded as ops/grid.py::fma rounds
// campos + raydir·t (the product of two floats is exact in float64: one
// rounding in the fma, one in the cast), and whether its voxel is occupied.
__device__ __forceinline__ bool occupied(const Params& p, const double* c,
                                         const double* dir, double t,
                                         float* pos) {
  unsigned v[3];
  bool inb = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos[a] = __double2float_rn(__fma_rn(dir[a], t, c[a]));
    v[a] = floor_bits(__fmul_rn(__fsub_rn(pos[a], p.mn[a]), p.inv[a]));
    inb = inb && v[a] < (unsigned)p.vdim[a];
  }
  return inb &&
         __ldg(p.occ + (v[0] * p.vdim[1] + v[1]) * p.vdim[2] + v[2]) > 0;
}

// STAGED: depths broadcast over the rays (strides 0, 0, 1), staged once a
// block as float64. SELECT: write the first SR occupied samples' positions,
// mask bits and the count; else (mask mode) write the [B,R,D] mask.
template <bool STAGED, bool SELECT>
__global__ void __launch_bounds__(WARPS * 32)
    occupancy_kernel(Params p) {
  extern __shared__ double s_t[];
  if (STAGED) {
    for (int d = threadIdx.x; d < p.D; d += blockDim.x)
      s_t[d] = (double)__ldg(p.tvals + d * p.tsd);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= p.B * p.R) return;
  const int b = n / p.R, r = n - b * p.R;
  double c[3], dir[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = (double)__ldg(p.campos + 3 * b + a);
    dir[a] = (double)__ldg(p.raydir + 3 * n + a);
  }
  const float* trow = p.tvals + b * p.tsb + r * p.tsr;
  const unsigned below = (1u << lane) - 1u;
  int found = 0;
  for (int d0 = 0; d0 < p.D; d0 += 32) {
    const int d = d0 + lane;
    float pos[3];
    bool occ = false;
    if (d0 + 32 <= p.D || d < p.D) {
      const double t = STAGED ? s_t[d] : (double)__ldg(trow + d * p.tsd);
      occ = occupied(p, c, dir, t, pos);
      if (!SELECT) p.valid[n * p.D + d] = occ;
    }
    if (SELECT) {
      // most steps hold no occupied sample: skip the ranking there
      const unsigned ballot = __ballot_sync(0xffffffffu, occ);
      if (ballot) {                           // uniform across the warp
        const int rank = found + __popc(ballot & below);
        if (occ && rank < p.SR) {
          float* out = p.loc + (n * p.SR + rank) * 3;
          out[0] = pos[0];
          out[1] = pos[1];
          out[2] = pos[2];
          p.smask[n * p.SR + rank] = 1;
        }
        found += __popc(ballot);
        if (found >= p.SR) break;
      }
    }
  }
  if (SELECT) {
    const int count = min(found, p.SR);
    float* loc = p.loc + n * p.SR * 3;
    for (int i = 3 * count + lane; i < 3 * p.SR; i += 32) loc[i] = 0.f;
    for (int s = count + lane; s < p.SR; s += 32) p.smask[n * p.SR + s] = 0;
    if (lane == 0) p.counts[n] = count;
  }
}

template <bool STAGED>
void launch(const Params& p, unsigned blocks, size_t smem,
            cudaStream_t stream) {
  if (p.counts)
    occupancy_kernel<STAGED, true><<<blocks, WARPS * 32, smem, stream>>>(p);
  else
    occupancy_kernel<STAGED, false><<<blocks, WARPS * 32, smem, stream>>>(p);
}

}  // namespace

// Select mode: loc, smask and counts given, valid null. Mask mode: loc,
// smask and counts null, valid given. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int occupancy_select(const float* campos, const float* raydir,
                                const float* tvals, const int8_t* occ,
                                float* loc, uint8_t* smask, int* counts,
                                uint8_t* valid, int tsb, int tsr, int tsd,
                                int B, int R, int D, int SR, float mn0,
                                float mn1, float mn2, float inv0, float inv1,
                                float inv2, int vx, int vy, int vz,
                                void* stream) {
  Params p{campos, raydir, tvals, occ, loc, smask, counts, valid,
           tsb, tsr, tsd, B, R, D, SR,
           {mn0, mn1, mn2}, {inv0, inv1, inv2}, {vx, vy, vz}};
  const int rays = B * R;
  if (rays > 0) {
    const unsigned blocks = (unsigned)((rays + WARPS - 1) / WARPS);
    if (tsb == 0 && tsr == 0 && D <= STAGE_MAX)
      launch<true>(p, blocks, (size_t)D * sizeof(double),
                   (cudaStream_t)stream);
    else
      launch<false>(p, blocks, 0, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
