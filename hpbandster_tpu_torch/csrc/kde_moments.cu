// Masked moments of the KDE bandwidth fit, for Hopper (sm_90a): for data
// f32[C, d] and masks f32[S, C] (S = 1 or 2 sides), per side s and dim j,
//   out[s][0][j] = sum_r m[s][r] * x[r][j]
//   out[s][1][j] = sum_r m[s][r] * x[r][j]^2
//   out[s][2][j] = sum_r m[s][r]           (the same for every j)
// The wrapper turns them into normal-reference bandwidths.
//
// Replaces the Pallas TPU kernel `_moments_kernel` in
// hpbandster_tpu/ops/pallas_kde.py (launched by `_masked_moments_padded`
// from `pallas_normal_reference_bandwidths`).
//
// What bounds it: bytes. Every element of the data and the masks is read
// once and used in a handful of float32 operations, so the card's memory
// rate, not its arithmetic, sets the floor (at the fit's main-path size,
// C = 256, launch latency sets the time instead).
//
// Design. The TPU kernel lets every grid step add into one output block,
// which is safe only because a TPU grid runs in order. Blocks on the card
// run concurrently, so this is two passes with no atomics:
// * pass 1, grid (row blocks, dim chunks of 8): each thread walks a fixed
//   grid-stride set of rows and keeps the sums of its dims for both sides
//   in registers; the block reduces them with warp shuffles in a fixed
//   order and writes one partial per block, partial[block][s][stat][j];
// * pass 2, one block per output element: sums that element's partials
//   over the row blocks, again in a fixed order.
// The launch geometry depends only on C and d, and no float is added in an
// order that varies from run to run, so the result is the same bit for bit
// on every run (a checkpoint-resumed sweep relies on that). Both sides of a
// fit share one launch pair, since both are masks over the same sorted
// rows. The kernel takes the exact d and C and a [S, C] mask: the TPU
// kernel's 128-lane padding and its mask broadcast to [C, 128] never exist.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // threads of a pass-1 block
constexpr int kWarps = kThreads / 32;
constexpr int kDimChunk = 8;                 // dims a pass-1 block sums
constexpr int kMaxSides = 2;
constexpr int kStatVals = 2 * kDimChunk + 1; // sum, sum of squares, count
constexpr int kVals = kMaxSides * kStatVals;
constexpr int kMaxRowBlocks = 4 * 132;       // four blocks per H100 SM
constexpr int kFinalThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // complete in lane 0
}

__global__ void moments_partial_kernel(const float* __restrict__ data,
                                       const float* __restrict__ masks,
                                       float* __restrict__ partial, int C,
                                       int d, int sides) {
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * kDimChunk;
  const int nj = min(kDimChunk, d - j0);
  float s1[kMaxSides][kDimChunk];
  float s2[kMaxSides][kDimChunk];
  float cnt[kMaxSides];
#pragma unroll
  for (int s = 0; s < kMaxSides; ++s) {
    cnt[s] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kDimChunk; ++jj) {
      s1[s][jj] = 0.0f;
      s2[s][jj] = 0.0f;
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + tid; r < C; r += stride) {
    float m[kMaxSides];
#pragma unroll
    for (int s = 0; s < kMaxSides; ++s) {
      m[s] = s < sides ? masks[(int64_t)s * C + r] : 0.0f;
      cnt[s] += m[s];
    }
    const float* row = data + r * d + j0;
#pragma unroll
    for (int jj = 0; jj < kDimChunk; ++jj) {
      if (jj < nj) {
        const float x = row[jj];
#pragma unroll
        for (int s = 0; s < kMaxSides; ++s) {
          const float xm = x * m[s];
          s1[s][jj] += xm;
          s2[s][jj] += xm * x;
        }
      }
    }
  }

  __shared__ float red[kWarps][kVals];
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < kMaxSides; ++s) {
#pragma unroll
    for (int jj = 0; jj < kDimChunk; ++jj) {
      const float a = warp_sum(s1[s][jj]);
      const float b = warp_sum(s2[s][jj]);
      if (lane == 0) {
        red[warp][s * kStatVals + jj] = a;
        red[warp][s * kStatVals + kDimChunk + jj] = b;
      }
    }
    const float c = warp_sum(cnt[s]);
    if (lane == 0) red[warp][s * kStatVals + 2 * kDimChunk] = c;
  }
  __syncthreads();
  if (tid < kVals) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += red[w][tid];
    const int s = tid / kStatVals;
    const int k = tid - s * kStatVals;
    if (s < sides) {
      float* out = partial + ((int64_t)blockIdx.x * sides + s) * 3 * d;
      if (k < kDimChunk) {
        if (k < nj) out[j0 + k] = acc;
      } else if (k < 2 * kDimChunk) {
        if (k - kDimChunk < nj) out[d + j0 + k - kDimChunk] = acc;
      } else {
        for (int jj = 0; jj < nj; ++jj) out[2 * d + j0 + jj] = acc;
      }
    }
  }
}

// out[e] = sum over row blocks b of partial[b][e], one block per element e
__global__ void moments_final_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int row_blocks,
                                     int n_out) {
  const int e = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < row_blocks; b += kFinalThreads) {
    acc += partial[(int64_t)b * n_out + e];
  }
  acc = warp_sum(acc);
  __shared__ float red[kFinalThreads / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kFinalThreads / 32; ++w) total += red[w];
    out[e] = total;
  }
}

}  // namespace

extern "C" {

// Row blocks of pass 1 for C rows: the rows of the partial buffer the
// wrapper allocates, [row_blocks][sides][3][d].
int kde_moments_row_blocks(int C) {
  const int need = (C + kThreads - 1) / kThreads;
  return need < 1 ? 1 : (need > kMaxRowBlocks ? kMaxRowBlocks : need);
}

// Launches both passes on `stream`. Returns the CUDA error code (0 on
// success); the wrapper raises on anything else.
int kde_moments_launch(const float* data, const float* masks, float* partial,
                       float* out, int C, int d, int sides, void* stream) {
  if (C <= 0 || d <= 0 || sides < 1 || sides > kMaxSides) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_blocks = kde_moments_row_blocks(C);
  const dim3 grid(row_blocks, (d + kDimChunk - 1) / kDimChunk);
  moments_partial_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, masks, partial, C, d, sides);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = sides * 3 * d;
  moments_final_kernel<<<n_out, kFinalThreads, 0, (cudaStream_t)stream>>>(
      partial, out, row_blocks, n_out);
  return (int)cudaGetLastError();
}

const char* kde_moments_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
