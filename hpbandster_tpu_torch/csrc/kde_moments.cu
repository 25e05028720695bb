// Masked moments of the KDE bandwidth fit, for Hopper (sm_90a): for data
// f32[C, d] and masks f32[S, C] (S = 1 or 2 sides), per side s and dim j,
//   out[s][0][j] = sum_r m[s][r] * x[r][j]
//   out[s][1][j] = sum_r m[s][r] * x[r][j]^2
//   out[s][2][j] = sum_r m[s][r]           (the same for every j)
// and, from those sums in the same launch, the normal-reference bandwidths
//   n = max(count, 1), var = max(s2/n - (s1/n)^2, 0),
//   bw[s][j] = min(max(1.06 sqrt(var) n^(-1/(4+d)), min_bw), (k-1)/k)
// (the cap only on discrete dims, k = max(cards[j], 2)).
//
// Replaces the Pallas TPU kernel `_moments_kernel`
// (hpbandster_tpu/ops/pallas_kde.py:326, launched by `_masked_moments_padded`
// at :369 from `pallas_normal_reference_bandwidths` :382), and the small
// bandwidth epilogue that followed it.
//
// What bounds it on the H100: bytes. Every element of the data and the
// masks is read once and used in a handful of float32 operations, so the
// card's memory rate sets the floor; at the fit's main-path size (C = 256,
// d = 6, two sides) the launch itself sets the time.
//
// Design:
// * One launch. The TPU kernel lets every grid step add into one output
//   block, which is safe only because a TPU grid runs in order. Here each
//   block reduces a fixed grid-stride set of rows and writes one partial,
//   partial[block][s][stat][j]; every writing thread fences, then one thread
//   takes an atomicAdd ticket on an int32 counter. The block that draws the
//   last ticket sums all partials in block order 0..B-1 (read with __ldcg,
//   past L1), writes the moments and the bandwidths, and resets the counter
//   to 0 as its last write. Which block finishes last never changes the
//   order of a float add, so the result is the same bit for bit on every
//   run (a checkpoint-resumed sweep relies on that). Float atomics would
//   add in arrival order and lose that; the ticket is an integer.
// * Why one launch and not two (a second launch that sums the partials,
//   one block per (side, dim)): with the same pass-1 body the two measured
//   within a few percent of each other with the card kept busy, but with
//   calls back to back on an idle card, as in a host-bound sweep, the two
//   launches of a call spanned several times their device time
//   (compare_kernels.py; PERF.md has the numbers). One launch has no gap.
// * With one block (C <= 1024 rows at d <= 32: the main path's 256), the
//   block writes the result directly and touches neither partials nor
//   counter.
// * The counter is a zeroed int32 on the device that the wrapper allocates
//   once per device and stream; the partial buffer comes from PyTorch's
//   caching allocator per call; the kernel allocates nothing. A launch that
//   faults between its ticket and the reset leaves the counter dirty; the
//   fault is fatal to the CUDA context anyway.
// * All dims of a row per thread for d <= 32 (kernel instances for 8, 16 and
//   32 register dims), in 16-byte loads when d % 4 == 0 and the data is
//   16-byte aligned; wider spaces take dim chunks of 8 on a second grid axis.
//   Each thread keeps `kUnroll` rows of loads in flight before it adds them,
//   in row order. The grid comes from C and d only (`kde_moments_geometry`
//   in ops/cuda_kde.py).
// * Both sides of a fit share the launch: they are masks over the same rows.
// * The bandwidths are always written: one kernel mode serves the fit and
//   the plain moments. A caller that passes no `cards` gets every dim
//   treated as continuous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTailBatch = 72;  // partial loads a lane of the last block
                                // has in flight: one batch at the scale
                                // checks' grids

// One step of a warp reduce-scatter (recursive halving) over the values
// v[0..NVP*O/16): lanes with bit O set keep the upper half, the others the
// lower half, each adding its partner's copy of the half it keeps.
template <int NVP, int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[NVP],
                                                    int lane) {
  constexpr int kHalf = NVP * O / 32;
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float send = upper ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// Reduce-scatter of NVP values over a warp: afterwards lane l holds in
// v[0..NVP/32) the warp's totals of values l*NVP/32 ... (l+1)*NVP/32 - 1.
// Every total is formed by one lane in a fixed order, and the warp makes
// NVP*31/32 shuffles where a full reduction of each value would make 5*NVP.
template <int NVP>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NVP],
                                                    int lane) {
  static_assert(NVP % 32 == 0, "pad the values to a multiple of 32");
  reduce_scatter_step<NVP, 16>(v, lane);
  reduce_scatter_step<NVP, 8>(v, lane);
  reduce_scatter_step<NVP, 4>(v, lane);
  reduce_scatter_step<NVP, 2>(v, lane);
  reduce_scatter_step<NVP, 1>(v, lane);
}

// the bandwidth of one (side, dim) from its final sums, written with
// explicit _rn operations so no multiply-add is fused and the result follows
// the plain version's float32 steps
__device__ __forceinline__ float bandwidth(float s1, float s2, float cnt,
                                           float card, float min_bw,
                                           float bw_exp) {
  const float n = fmaxf(cnt, 1.0f);
  const float mean = __fdiv_rn(s1, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean)),
                          0.0f);
  float bw = __fmul_rn(__fmul_rn(1.06f, sqrtf(var)), powf(n, bw_exp));
  bw = fmaxf(bw, min_bw);
  if (card > 0.0f) {
    const float k = fmaxf(card, 2.0f);
    bw = fminf(bw, __fdiv_rn(k - 1.0f, k));
  }
  return bw;
}

// two blocks per SM for the narrow instance (its grid fills the card in
// one wave); the wider ones hold more sums in registers and run one
template <int DMAX, int SIDES>
__global__ void __launch_bounds__(kThreads, DMAX == 8 ? 2 : 1)
    moments_kernel(const float* __restrict__ data,
                   const float* __restrict__ masks, float* partial,
                   int* counter, float* __restrict__ out,
                   const float* __restrict__ cards, float* __restrict__ bw,
                   int C, int d, int vec4, float min_bw, float bw_exp) {
  constexpr int kUnroll = DMAX >= 32 ? 2 : 4;  // rows in flight per thread
  constexpr int kStat = 2 * DMAX + 1;          // sums, squares, count
  __shared__ float red[kWarps][SIDES * kStat];  // per-warp totals
  __shared__ int last;
  extern __shared__ float fin[];               // [SIDES][3][d]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = blockIdx.y * DMAX;
  const int nj = min(DMAX, d - j0);
  const int n_out = SIDES * 3 * d;
  const bool single = gridDim.x * gridDim.y == 1;

  float s1[SIDES][DMAX], s2[SIDES][DMAX], cnt[SIDES];
#pragma unroll
  for (int s = 0; s < SIDES; ++s) {
    cnt[s] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DMAX; ++jj) s1[s][jj] = s2[s][jj] = 0.0f;
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r0 = (int64_t)blockIdx.x * kThreads + tid; r0 < C;
       r0 += kUnroll * stride) {
    float x[kUnroll][DMAX];
    float m[kUnroll][SIDES];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * stride;
      const bool ok = r < C;
#pragma unroll
      for (int s = 0; s < SIDES; ++s) m[u][s] = ok ? masks[s * (int64_t)C + r] : 0.0f;
      const float* row = data + r * d + j0;
      if (vec4) {
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (ok && 4 * q < nj) v = *reinterpret_cast<const float4*>(row + 4 * q);
          x[u][4 * q] = v.x;
          x[u][4 * q + 1] = v.y;
          x[u][4 * q + 2] = v.z;
          x[u][4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < DMAX; ++jj) x[u][jj] = (ok && jj < nj) ? row[jj] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < SIDES; ++s) {
        cnt[s] += m[u][s];
#pragma unroll
        for (int jj = 0; jj < DMAX; ++jj) {
          const float xm = x[u][jj] * m[u][s];
          s1[s][jj] += xm;
          s2[s][jj] += xm * x[u][jj];
        }
      }
    }
  }

  // block reduction: each warp reduce-scatters its values, then the warps
  // are added in order
  constexpr int kVals = SIDES * kStat;
  constexpr int kPadded = (kVals + 31) / 32 * 32;
  float v[kPadded];
#pragma unroll
  for (int i = 0; i < kPadded; ++i) v[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < SIDES; ++s) {
#pragma unroll
    for (int jj = 0; jj < DMAX; ++jj) {
      v[s * kStat + jj] = s1[s][jj];
      v[s * kStat + DMAX + jj] = s2[s][jj];
    }
    v[s * kStat + 2 * DMAX] = cnt[s];
  }
  warp_reduce_scatter(v, lane);
#pragma unroll
  for (int i = 0; i < kPadded / 32; ++i) {
    const int idx = lane * (kPadded / 32) + i;
    if (idx < kVals) red[warp][idx] = v[i];
  }
  __syncthreads();
  if (tid < SIDES * kStat) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += red[w][tid];
    const int s = tid / kStat;
    const int k = tid - s * kStat;
    // single block: straight into fin; else this block's partial row
    float* dst = single ? fin + s * 3 * d
                        : partial + (int64_t)blockIdx.x * n_out + s * 3 * d;
    if (k < DMAX) {
      if (k < nj) dst[j0 + k] = acc;
    } else if (k < 2 * DMAX) {
      if (k - DMAX < nj) dst[d + j0 + k - DMAX] = acc;
    } else {
      for (int jj = 0; jj < nj; ++jj) dst[2 * d + j0 + jj] = acc;
    }
    if (!single) __threadfence();  // the partial is visible before the ticket
  }
  if (!single) {
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(counter, 1);
      last = ticket == (int)(gridDim.x * gridDim.y) - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // G lanes per output element (as many as the block holds, up to a
    // warp), each over the blocks in a fixed interleave, kTailBatch loads
    // in flight at a time, then a fixed butterfly over the G lanes
    int G = 32;
    while (G > 1 && n_out * G > kThreads) G >>= 1;
    const int g = tid & (G - 1);
    const int gx = (int)gridDim.x;
    for (int e0 = 0; e0 < n_out; e0 += kThreads / G) {
      const int e = e0 + tid / G;
      float acc = 0.0f;
      if (e < n_out) {
        for (int b0 = g; b0 < gx; b0 += kTailBatch * G) {
          float v[kTailBatch];
#pragma unroll
          for (int i = 0; i < kTailBatch; ++i) {
            const int b = b0 + i * G;
            v[i] = b < gx ? __ldcg(partial + (int64_t)b * n_out + e) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kTailBatch; ++i) acc += v[i];
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (g == 0 && e < n_out) fin[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n_out; e += kThreads) out[e] = fin[e];
  for (int e = tid; e < SIDES * d; e += kThreads) {
    const int s = e / d;
    const int j = e - s * d;
    const float* f = fin + s * 3 * d;
    bw[e] = bandwidth(f[j], f[d + j], f[2 * d + j],
                      cards == nullptr ? 0.0f : cards[j], min_bw, bw_exp);
  }
  if (!single) {
    __syncthreads();
    if (tid == 0) *counter = 0;  // the last write: ready for the next launch
  }
}

template <int DMAX>
int launch_dims(const float* data, const float* masks, float* partial,
                int* counter, float* out, const float* cards, float* bw,
                int C, int d, int sides, int row_blocks, int dim_chunks,
                int vec4, float min_bw, float bw_exp, cudaStream_t stream) {
  const dim3 grid(row_blocks, dim_chunks);
  const size_t smem = sizeof(float) * (size_t)sides * 3 * d;
  if (sides == 1) {
    moments_kernel<DMAX, 1><<<grid, kThreads, smem, stream>>>(
        data, masks, partial, counter, out, cards, bw, C, d, vec4, min_bw,
        bw_exp);
  } else {
    moments_kernel<DMAX, 2><<<grid, kThreads, smem, stream>>>(
        data, masks, partial, counter, out, cards, bw, C, d, vec4, min_bw,
        bw_exp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the moments `out` f32[sides, 3, d] and the bandwidths `bw`
// f32[sides, d] (`cards` may be null: every dim continuous) on `stream`,
// with the geometry `kde_moments_geometry` chose:
// `row_blocks` x `dim_chunks` blocks of 256 threads, `dmax` register dims
// (8, 16 or 32), 16-byte loads when `vec4`. `partial` holds row_blocks x
// sides x 3 x d floats and `counter` one zeroed int32 when there is more than
// one block (both unused otherwise). Returns the CUDA error code (0 on
// success); the wrapper raises on anything else.
int kde_moments_launch(const float* data, const float* masks, float* partial,
                       int* counter, float* out, const float* cards,
                       float* bw, int C, int d, int sides, int dmax,
                       int row_blocks, int dim_chunks, int vec4, float min_bw,
                       float bw_exp, void* stream) {
  if (C <= 0 || d <= 0 || sides < 1 || sides > 2 || row_blocks < 1 ||
      dim_chunks < 1 || (dim_chunks - 1) * dmax >= d || !out || !bw ||
      ((row_blocks > 1 || dim_chunks > 1) && (!partial || !counter))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dmax) {
    case 8:
      return launch_dims<8>(data, masks, partial, counter, out, cards, bw, C,
                            d, sides, row_blocks, dim_chunks, vec4, min_bw,
                            bw_exp, st);
    case 16:
      return launch_dims<16>(data, masks, partial, counter, out, cards, bw, C,
                             d, sides, row_blocks, dim_chunks, vec4, min_bw,
                             bw_exp, st);
    case 32:
      return launch_dims<32>(data, masks, partial, counter, out, cards, bw, C,
                             d, sides, row_blocks, dim_chunks, vec4, min_bw,
                             bw_exp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* kde_moments_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
