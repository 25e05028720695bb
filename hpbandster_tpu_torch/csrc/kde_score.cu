// BOHB acquisition scorer for Hopper (sm_90a): log l(x) - log g(x) for every
// candidate against a good and a bad mixed-type KDE, in one launch.
//
// Replaces the Pallas TPU kernel `_score_kernel` in
// hpbandster_tpu/ops/pallas_kde.py (launched by `_score_padded`). For each
// candidate x and each observation i of a side (good, then bad) it sums the
// per-dim log kernel (vartype 0 Gaussian, 1 Aitchison-Aitken, 2 Wang-van
// Ryzin), takes the masked logsumexp over observations, subtracts
// log(max(sum(mask), 1)), floors both sides at LOG_PDF_FLOOR and writes
// max(lg, F) - max(lb, F).
//
// What bounds it: arithmetic. The work is S * (Ng + Nb) * d kernel terms and
// S * (Ng + Nb) exponentials over a few hundred kilobytes of input, so the
// card's float32 rate, not its memory, sets the floor.
//
// Design, kept simple and exact:
// * one thread per candidate, 128 threads per block; the candidate rows of
//   a block sit in shared memory, transposed, so a thread reads its own
//   column without bank conflicts;
// * the per-dim constants of both sides (bandwidth, log bandwidth and the
//   discrete kernels' logs) are computed once per block into shared memory;
// * observations stream through shared memory in tiles, good side first,
//   then bad; each thread keeps an online logsumexp (running max and sum),
//   so the [TS, N] tile the TPU kernel held in VMEM never exists;
// * the kernel takes the exact d and N, so no lane padding and no inert
//   vartype code is needed.
// An all-masked side reproduces the reference's value exactly: max = -inf
// gives m_safe = 0 and log(max(0, 1e-38)), which the floor then absorbs.
// Built without --use_fast_math: parity rests on IEEE logf/log1pf/expf and
// correctly rounded division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // candidates per block
constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
constexpr float kLogHalf = -0.69314718055994530942f;

// per-dim constants of one side, struct-of-arrays in shared memory
struct SideConsts {
  float* bw;     // max(bw, 1e-10)
  float* logbw;  // log(bw)
  float* l1m;    // log1p(-lam)
  float* lu;     // log(lam) - log(k - 1)
  float* lo;     // log(0.5) + log1p(-lam)
  float* loglam; // log(lam)
};

__device__ __forceinline__ void fill_consts(const SideConsts& c, int j,
                                            const float* bw_in,
                                            float km1) {
  float bw = fmaxf(bw_in[j], 1e-10f);
  float lam = fminf(fmaxf(bw, 1e-10f), 1.0f - 1e-7f);
  float l1m = log1pf(-lam);
  float loglam = logf(lam);
  c.bw[j] = bw;
  c.logbw[j] = logf(bw);
  c.l1m[j] = l1m;
  c.lu[j] = loglam - logf(km1);
  c.lo[j] = kLogHalf + l1m;
  c.loglam[j] = loglam;
}

// masked mixture log-density of this thread's candidate under one side
__device__ float side_logpdf(const float* __restrict__ data,
                             const float* __restrict__ mask, int n, int d,
                             const SideConsts& c, const float* vt,
                             const float* xs, float* tile, float* tmask,
                             int tile_n) {
  const int tid = threadIdx.x;
  float m = -INFINITY;  // running max over masked-in rows
  float s = 0.0f;       // running sum of exp(row - m)
  float n_eff = 0.0f;   // sum(mask), summed in row order by every thread
  for (int base = 0; base < n; base += tile_n) {
    const int rows = min(tile_n, n - base);
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < rows * d; e += blockDim.x) {
      tile[e] = data[(int64_t)base * d + e];
    }
    for (int r = tid; r < rows; r += blockDim.x) {
      tmask[r] = mask[base + r];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float w = tmask[r];
      n_eff += w;
      if (!(w > 0.0f)) continue;  // log weight -inf: contributes exp(-inf)=0
      const float* mu = tile + r * d;
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float diff = xs[j * kThreads + tid] - mu[j];
        const float code = vt[j];
        float term;
        if (code == 0.0f) {
          const float z = diff / c.bw[j];
          term = -0.5f * (z * z) - c.logbw[j] - kLogSqrt2Pi;
        } else {
          const bool same = diff * diff < 0.25f;
          if (code == 1.0f) {
            term = same ? c.l1m[j] : c.lu[j];
          } else if (code == 2.0f) {
            term = same ? c.l1m[j] : c.lo[j] + fabsf(diff) * c.loglam[j];
          } else {
            term = 0.0f;
          }
        }
        acc += term;
      }
      if (acc > m) {
        s = s * expf(m - acc) + 1.0f;
        m = acc;
      } else if (acc == -INFINITY) {
        // an impossible row adds exp(-inf) = 0; skip it so -inf - -inf
        // never forms a NaN while the running max is still -inf
      } else {
        s += expf(acc - m);
      }
    }
  }
  const float m_safe = isfinite(m) ? m : 0.0f;
  return m_safe + logf(fmaxf(s, 1e-38f)) - logf(fmaxf(n_eff, 1.0f));
}

__global__ void kde_score_kernel(const float* __restrict__ cands,
                                 const float* __restrict__ gdata,
                                 const float* __restrict__ gmask,
                                 const float* __restrict__ gbw,
                                 const float* __restrict__ bdata,
                                 const float* __restrict__ bmask,
                                 const float* __restrict__ bbw,
                                 const float* __restrict__ vartypes,
                                 const float* __restrict__ cards,
                                 float* __restrict__ out, int S, int d, int ng,
                                 int nb, int tile_n, float floor_value) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [d][kThreads] candidate columns
  float* vt = xs + d * kThreads;           // [d]
  SideConsts gc, bc;
  float* p = vt + d;
  gc.bw = p; p += d; gc.logbw = p; p += d; gc.l1m = p; p += d;
  gc.lu = p; p += d; gc.lo = p; p += d; gc.loglam = p; p += d;
  bc.bw = p; p += d; bc.logbw = p; p += d; bc.l1m = p; p += d;
  bc.lu = p; p += d; bc.lo = p; p += d; bc.loglam = p; p += d;
  float* tile = p;                         // [tile_n][d]
  float* tmask = tile + tile_n * d;        // [tile_n]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kThreads;
  for (int j = tid; j < d; j += blockDim.x) {
    const float km1 = fmaxf(cards[j] - 1.0f, 1.0f);
    vt[j] = vartypes[j];
    fill_consts(gc, j, gbw, km1);
    fill_consts(bc, j, bbw, km1);
  }
  // stage this block's candidates transposed: xs[j][t] = cands[row0 + t][j]
  for (int e = tid; e < kThreads * d; e += blockDim.x) {
    const int t = e / d;
    const int j = e - t * d;
    const int row = row0 + t;
    xs[j * kThreads + t] = row < S ? cands[(int64_t)row * d + j] : 0.0f;
  }
  // side_logpdf starts with a barrier, which also publishes the stores above
  const float lg = side_logpdf(gdata, gmask, ng, d, gc, vt, xs, tile, tmask,
                               tile_n);
  const float lb = side_logpdf(bdata, bmask, nb, d, bc, vt, xs, tile, tmask,
                               tile_n);
  const int row = row0 + tid;
  if (row < S) {
    out[row] = fmaxf(lg, floor_value) - fmaxf(lb, floor_value);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the launch below asks for.
size_t kde_score_smem_bytes(int d, int tile_n) {
  return sizeof(float) *
         ((size_t)d * kThreads + 13 * (size_t)d + (size_t)tile_n * d + tile_n);
}

// Launches the scorer on `stream`. Returns the CUDA error code of the launch
// (0 on success); the wrapper raises on anything else.
int kde_score_launch(const float* cands, const float* gdata,
                     const float* gmask, const float* gbw, const float* bdata,
                     const float* bmask, const float* bbw,
                     const float* vartypes, const float* cards, float* out,
                     int S, int d, int ng, int nb, int tile_n,
                     float floor_value, void* stream) {
  if (S <= 0) return 0;
  const size_t smem = kde_score_smem_bytes(d, tile_n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kde_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (S + kThreads - 1) / kThreads;
  kde_score_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes, cards, out, S, d,
      ng, nb, tile_n, floor_value);
  return (int)cudaGetLastError();
}

const char* kde_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
