// BOHB acquisition scorer for Hopper (sm_90a): log l(x) - log g(x) for every
// candidate against a good and a bad mixed-type KDE, in one launch.
//
// Replaces the Pallas TPU kernel `_score_kernel`
// (hpbandster_tpu/ops/pallas_kde.py:65, launched by `_score_padded` at :156).
// For each candidate x and each observation i of a side (good, then bad) it
// sums the per-dim log kernel (vartype 0 Gaussian, 1 Aitchison-Aitken, 2
// Wang-van Ryzin, any other code inert), takes the masked logsumexp over
// observations, subtracts log(max(sum(mask), 1)), floors both sides at
// LOG_PDF_FLOOR and writes max(lg, F) - max(lb, F).
//
// What bounds it on the H100. The work is S * live_rows * d kernel terms and
// S * live_rows exponentials over a few hundred kilobytes of input. At the
// sweep's sizes (S <= 5184, ~15 live rows out of 2 x 256) that is far below
// a microsecond of the card's float32 or special-function rate: the time is
// latency (the dependent chain of one candidate's rows and the block's
// barriers) and the launch itself.
//
// Design:
// * Compaction. Each block walks both sides' masks once, in lockstep passes
//   of `rpt` x 128 rows: every thread loads its mask values of both sides
//   at once (the first pass goes out at the kernel's start, beside the
//   candidates and the bandwidths), then copies its live rows with all
//   their loads in flight together. The masked-in rows are appended, in
//   row order, to one list per side in shared memory: a per-warp
//   `__ballot_sync`/`__popc` prefix, then the warps' counts in a fixed
//   order. n_eff is the same fixed-order sum of the mask. Rows are stored
//   raw (the discrete match test reads the raw difference) with an odd row
//   stride, so lanes reading different rows hit different banks. When a list
//   could overflow its `cap` rows, the block scores both lists and starts
//   new ones. So the pair loop visits the live rows (~7 + ~12 on the dynamic
//   tier), not the 256 + 256 rows of the buffers, and the two sides' rows
//   are scored in one loop, two independent chains.
// * K lanes per candidate (K a power of two <= 32, 128 / K candidates per
//   128-thread block). Lane l takes each list's rows l, l + K, ... and keeps
//   an online (max, sum) pair per side. The K lanes then take a butterfly
//   max, rescale their sums to it (one exponential) and take a butterfly
//   sum, written so that both partners of a step compute the same bits.
// * Geometry from shapes only. The wrapper (`kde_score_geometry` in
//   ops/cuda_kde.py) picks K, the grid, `rpt` and `cap` from S, d and the
//   buffer sizes, never from a mask: the same inputs give the same bits on
//   every run, which a checkpoint-resumed sweep relies on.
// * No division in the pair loop. Per side and dim the block computes once
//   1/bw, -log bw - log sqrt(2 pi) (summed over the continuous dims into one
//   side constant) and the discrete kernels' logs; a continuous term is then
//   a subtract, a multiply and a fused multiply-add. Every vartype shares
//   one term formula with per-dim coefficients (no branch in the loop), and
//   an all-continuous space skips the discrete coefficients. The difference is taken before
//   scaling, (x - o) * (1/bw), and not as x/bw - o/bw: with bw at the fit's
//   1e-3 floor, x/bw reaches 1e3 and the rounding of the two quotients
//   would cost ~1e-3 in a score, where the difference first keeps the error
//   relative to z itself.
// * The candidate's coordinates live in registers for d <= 32 (a kernel
//   instance per register width 8, 16, 32) and in shared memory beyond.
// * No tensor cores: the contraction depth is d = 6-16, the work is bound by
//   exponentials and latency, and TF32 rounding of z = diff/bw (up to ~1e2)
//   would break the 1e-4 score tolerance.
// An all-masked side leaves every lane's max at -inf; the merge never forms
// -inf - -inf, and the side gives m_safe = 0, log(1e-38) - log(1), which the
// floor then absorbs, as in the reference.
// Built without --use_fast_math: parity rests on IEEE logf/log1pf/expf and
// correctly rounded division (in 1/bw). Against the plain version the
// reordered sums move last bits only, inside the 1e-4 score tolerance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerThread = 2;    // rows of a side a thread loads per pass
constexpr int kSideFloats = 6;          // per-dim constant arrays of a side
constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
constexpr float kLogHalf = -0.69314718055994530942f;
constexpr unsigned kFull = 0xffffffffu;

// Per-side constants in shared memory, each array [d], then one scalar:
//   inv (1/bw), cc (-log bw - log sqrt(2 pi)), and the coefficients of one
//   term formula for every vartype,
//     term = qa z^2 + (diff^2 < 0.25 ? same : other + slope |diff|),
//   z = diff * inv: Gaussian qa = -1/2 and the rest 0; Aitchison-Aitken
//   same = log1p(-lam), other = log lam - log(k - 1); Wang-van Ryzin
//   same = log1p(-lam), other = log 0.5 + log1p(-lam), slope = log lam; an
//   inert code all 0. At [6d] the sum of cc over the continuous dims.
__device__ __forceinline__ void fill_consts(float* c, int j, int d,
                                            float bw_in, float km1,
                                            float code) {
  const float bw = fmaxf(bw_in, 1e-10f);
  const float lam = fminf(fmaxf(bw, 1e-10f), 1.0f - 1e-7f);
  const float l1m = log1pf(-lam);
  const float loglam = logf(lam);
  const bool cont = code == 0.0f;
  const bool unord = code == 1.0f;
  const bool ord = code == 2.0f;
  c[j] = cont ? 1.0f / bw : 0.0f;
  c[d + j] = -logf(bw) - kLogSqrt2Pi;
  c[2 * d + j] = cont ? -0.5f : 0.0f;
  c[3 * d + j] = unord || ord ? l1m : 0.0f;
  c[4 * d + j] = unord ? loglam - logf(km1) : (ord ? kLogHalf + l1m : 0.0f);
  c[5 * d + j] = ord ? loglam : 0.0f;
}

// acc plus the log kernel of dim j for the raw difference `diff`, any
// vartype, without a branch
__device__ __forceinline__ float add_term(float acc, float diff,
                                          const float* c, int j, int d) {
  const float z = diff * c[j];
  const float other = c[4 * d + j] + fabsf(diff) * c[5 * d + j];
  const float t = diff * diff < 0.25f ? c[3 * d + j] : other;
  return fmaf(c[2 * d + j] * z, z, acc) + t;
}

// online logsumexp: push one row's log-density
__device__ __forceinline__ void lse_push(float a, float& m, float& s) {
  if (a > m) {
    s = s * expf(m - a) + 1.0f;
    m = a;
  } else if (a != -INFINITY) {
    s += expf(a - m);
  }
}

// The side's log-density from the K lanes' online (max, sum) pairs: a
// butterfly max, each lane's sum rescaled to it (one exponential), a
// butterfly sum. Every step is symmetric bit for bit (the product is never
// fused into the first add), so all K lanes end with the same value, and
// the order of the adds is fixed by the geometry.
__device__ __forceinline__ float finish_side(float m, float s, float n_eff,
                                             int K) {
  float mx = m;
  for (int o = K >> 1; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  // an empty lane adds 0 (and -inf - -inf never forms)
  float t = m == -INFINITY ? 0.0f : __fmul_rn(s, expf(m - mx));
  for (int o = K >> 1; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  const float m_safe = isfinite(mx) ? mx : 0.0f;
  return m_safe + logf(fmaxf(t, 1e-38f)) - logf(fmaxf(n_eff, 1.0f));
}

__device__ __forceinline__ float warp_sum_xor(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One thread's share of a compaction pass over one side: its mask values,
// loaded together
struct Pass {
  float w[kMaxRowsPerThread];
};

__device__ __forceinline__ void load_pass(Pass& p,
                                          const float* __restrict__ mask,
                                          int n, int base, int rpt) {
#pragma unroll
  for (int k = 0; k < kMaxRowsPerThread; ++k) {
    const int r = base + k * kThreads + threadIdx.x;
    p.w[k] = (k < rpt && r < n) ? mask[r] : 0.0f;
  }
}

// per-warp live counts and mask sums of one side's pass, and each of this
// thread's rows' rank among its warp's live rows
__device__ __forceinline__ void count_pass(const Pass& p, int rpt,
                                           int* wcnt, float* wsum,
                                           int (&pre)[kMaxRowsPerThread]) {
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const unsigned lt = (1u << wl) - 1u;
#pragma unroll
  for (int k = 0; k < kMaxRowsPerThread; ++k) {
    if (k < rpt) {
      const unsigned bal = __ballot_sync(kFull, p.w[k] > 0.0f);
      pre[k] = __popc(bal & lt);
      const float ws = warp_sum_xor(p.w[k]);
      if (wl == 0) {
        wcnt[k * kWarps + warp] = __popc(bal);
        wsum[k * kWarps + warp] = ws;
      }
    }
  }
}

// append this thread's live rows of the pass to the side's list, in row
// order (rows are ordered (k, warp, lane)); advance the list length and
// the side's mask sum the same way in every thread
template <int DMAX>
__device__ __forceinline__ void place_pass(const Pass& p,
                                           const float* __restrict__ data,
                                           int d, int base, int rpt,
                                           const int* wcnt, const float* wsum,
                                           int (&pre)[kMaxRowsPerThread],
                                           float* rows, int& nlive,
                                           float& n_eff) {
  const int warp = threadIdx.x >> 5;
  const int ds = d | 1;
  int off = nlive;
  float msum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxRowsPerThread; ++k) {
    if (k < rpt) {
      for (int wi = 0; wi < kWarps; ++wi) {
        if (wi == warp) pre[k] += off;
        off += wcnt[k * kWarps + wi];
        msum += wsum[k * kWarps + wi];
      }
    }
  }
  n_eff += msum;
  nlive = off;
#pragma unroll
  for (int k = 0; k < kMaxRowsPerThread; ++k) {
    if (k < rpt && p.w[k] > 0.0f) {
      float* dst = rows + pre[k] * ds;
      const float* src =
          data + (int64_t)(base + k * kThreads + threadIdx.x) * d;
      if constexpr (DMAX > 0) {
        float v[DMAX];  // all loads in flight before the stores
#pragma unroll
        for (int j = 0; j < DMAX; ++j) v[j] = j < d ? src[j] : 0.0f;
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          if (j < d) dst[j] = v[j];
        }
      } else {
        for (int j = 0; j < d; ++j) dst[j] = src[j];
      }
    }
  }
}

// log-density of the candidate against one listed row `mu` of a side with
// constants `c`; all-continuous spaces skip the discrete coefficients
template <int DMAX>
__device__ __forceinline__ float row_logpdf(
    const float* mu, const float (&xr)[DMAX > 0 ? DMAX : 1], const float* xsm,
    int d, const float* c, bool all_cont) {
  float acc = c[kSideFloats * d];  // the side constant
  if constexpr (DMAX > 0) {
    if (all_cont) {
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) {
          const float z = (xr[j] - mu[j]) * c[j];
          acc = fmaf(-0.5f * z, z, acc);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) acc = add_term(acc, xr[j] - mu[j], c, j, d);
      }
    }
  } else {
    for (int j = 0; j < d; ++j) acc = add_term(acc, xsm[j] - mu[j], c, j, d);
  }
  return acc;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    kde_score_kernel(const float* __restrict__ cands,
                     const float* __restrict__ gdata,
                     const float* __restrict__ gmask,
                     const float* __restrict__ gbw,
                     const float* __restrict__ bdata,
                     const float* __restrict__ bmask,
                     const float* __restrict__ bbw,
                     const float* __restrict__ vartypes,
                     const float* __restrict__ cards, float* __restrict__ out,
                     int S, int d, int ng, int nb, int log2k, int cap, int rpt,
                     float floor_value) {
  extern __shared__ float smem[];
  // layout (floats): code [d] | good consts [6d + 1] | bad consts [6d + 1] |
  // all-continuous flag [1] | wsum [2][8] | wcnt [2][8] | candidates
  // [cpb][d] (DMAX == 0 only) | good list [cap][d | 1] | bad list
  // [cap][d | 1]; `kde_score_geometry` sizes it the same way
  constexpr int kPassSlots = kMaxRowsPerThread * kWarps;
  const int side_len = kSideFloats * d + 1;
  const int ds = d | 1;
  float* code = smem;
  float* cg = code + d;
  float* cb = cg + side_len;
  float* flag = cb + side_len;
  float* wsum_g = flag + 1;
  float* wsum_b = wsum_g + kPassSlots;
  int* wcnt_g = reinterpret_cast<int*>(wsum_b + kPassSlots);
  int* wcnt_b = wcnt_g + kPassSlots;
  float* xs = reinterpret_cast<float*>(wcnt_b + kPassSlots);
  const int cpb = kThreads >> log2k;  // candidates per block
  float* rows_g = xs + (DMAX == 0 ? cpb * d : 0);
  float* rows_b = rows_g + cap * ds;

  const int tid = threadIdx.x;
  const int K = 1 << log2k;
  const int lane = tid & (K - 1);
  const int cand = tid >> log2k;
  const int row = blockIdx.x * cpb + cand;
  // both sides' first passes go out first: the loads overlap the constants
  Pass pg, pb;
  load_pass(pg, gmask, ng, 0, rpt);
  load_pass(pb, bmask, nb, 0, rpt);
  for (int j = tid; j < d; j += kThreads) {
    const float km1 = fmaxf(cards[j] - 1.0f, 1.0f);
    const float vt = vartypes[j];
    code[j] = vt;
    fill_consts(cg, j, d, gbw[j], km1, vt);
    fill_consts(cb, j, d, bbw[j], km1, vt);
  }
  float xr[DMAX > 0 ? DMAX : 1];
  if constexpr (DMAX > 0) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      xr[j] = (j < d && row < S) ? cands[(int64_t)row * d + j] : 0.0f;
    }
  } else {
    xr[0] = 0.0f;
    for (int e = tid; e < cpb * d; e += kThreads) {
      const int t = e / d;
      const int r = blockIdx.x * cpb + t;
      xs[e] = r < S ? cands[(int64_t)r * d + (e - t * d)] : 0.0f;
    }
  }
  const float* xsm = xs + cand * d;
  __syncthreads();
  if (tid == 0) {  // each side's constant, summed over dims in order
    float sum_g = 0.0f, sum_b = 0.0f;
    bool all_cont = true;
    for (int j = 0; j < d; ++j) {
      if (code[j] == 0.0f) {
        sum_g += cg[d + j];
        sum_b += cb[d + j];
      } else {
        all_cont = false;
      }
    }
    cg[kSideFloats * d] = sum_g;
    cb[kSideFloats * d] = sum_b;
    *flag = all_cont ? 1.0f : 0.0f;
  }

  // both sides compact in lockstep, each into its own list; the lists are
  // scored together when either could overflow, and after the last pass
  const int n_max = max(ng, nb);
  const int pass_rows = rpt * kThreads;
  float mg = -INFINITY, sg = 0.0f, ng_eff = 0.0f;
  float mb = -INFINITY, sb = 0.0f, nb_eff = 0.0f;
  int lg_n = 0, lb_n = 0;  // list lengths, the same in every thread
  for (int base = 0; base < n_max; base += pass_rows) {
    if (base > 0) {
      load_pass(pg, gmask, ng, base, rpt);
      load_pass(pb, bmask, nb, base, rpt);
    }
    __syncthreads();  // earlier readers of the lists and counters are done
    int pre_g[kMaxRowsPerThread], pre_b[kMaxRowsPerThread];
    count_pass(pg, rpt, wcnt_g, wsum_g, pre_g);
    count_pass(pb, rpt, wcnt_b, wsum_b, pre_b);
    __syncthreads();
    place_pass<DMAX>(pg, gdata, d, base, rpt, wcnt_g, wsum_g, pre_g, rows_g, lg_n,
               ng_eff);
    place_pass<DMAX>(pb, bdata, d, base, rpt, wcnt_b, wsum_b, pre_b, rows_b, lb_n,
               nb_eff);
    if (base + pass_rows >= n_max || lg_n + pass_rows > cap ||
        lb_n + pass_rows > cap) {
      __syncthreads();  // the lists are complete
      const bool all_cont = *flag != 0.0f;
      for (int r = lane; r < max(lg_n, lb_n); r += K) {
        if (r < lg_n) {
          lse_push(row_logpdf<DMAX>(rows_g + r * ds, xr, xsm, d, cg,
                                    all_cont),
                   mg, sg);
        }
        if (r < lb_n) {
          lse_push(row_logpdf<DMAX>(rows_b + r * ds, xr, xsm, d, cb,
                                    all_cont),
                   mb, sb);
        }
      }
      lg_n = lb_n = 0;  // the next pass starts with a barrier before it writes
    }
  }
  const float lg = finish_side(mg, sg, ng_eff, K);
  const float lb = finish_side(mb, sb, nb_eff, K);
  if (lane == 0 && row < S) {
    out[row] = fmaxf(lg, floor_value) - fmaxf(lb, floor_value);
  }
}

__global__ void noop_kernel() {}

template <int DMAX>
int launch(const float* cands, const float* gdata, const float* gmask,
           const float* gbw, const float* bdata, const float* bmask,
           const float* bbw, const float* vartypes, const float* cards,
           float* out, int S, int d, int ng, int nb, int log2k, int blocks,
           int cap, int rpt, int smem, float floor_value,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {  // wide spaces only; the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(
        kde_score_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  kde_score_kernel<DMAX><<<blocks, kThreads, smem, stream>>>(
      cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes, cards, out, S, d,
      ng, nb, log2k, cap, rpt, floor_value);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scorer on `stream` with the geometry `kde_score_geometry`
// chose (lanes 2^log2k, `blocks` blocks of 128 threads, `cap` list rows,
// `rpt` mask rows per thread and pass, `smem` bytes, register width `dmax`
// in {0, 8, 16, 32}). Returns the CUDA error code of the launch (0 on
// success); the wrapper raises on anything else.
int kde_score_launch(const float* cands, const float* gdata,
                     const float* gmask, const float* gbw, const float* bdata,
                     const float* bmask, const float* bbw,
                     const float* vartypes, const float* cards, float* out,
                     int S, int d, int ng, int nb, int log2k, int blocks,
                     int cap, int rpt, int dmax, int smem, float floor_value,
                     void* stream) {
  if (S <= 0) return 0;
  if (d <= 0 || log2k < 0 || log2k > 5 || rpt < 1 ||
      rpt > kMaxRowsPerThread || cap < rpt * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dmax) {
    case 8:
      return launch<8>(cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes,
                       cards, out, S, d, ng, nb, log2k, blocks, cap, rpt,
                       smem, floor_value, st);
    case 16:
      return launch<16>(cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes,
                        cards, out, S, d, ng, nb, log2k, blocks, cap, rpt,
                        smem, floor_value, st);
    case 32:
      return launch<32>(cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes,
                        cards, out, S, d, ng, nb, log2k, blocks, cap, rpt,
                        smem, floor_value, st);
    case 0:
      return launch<0>(cands, gdata, gmask, gbw, bdata, bmask, bbw, vartypes,
                       cards, out, S, d, ng, nb, log2k, blocks, cap, rpt,
                       smem, floor_value, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel on `stream`, launched through the same route: the least
// any launch of this library costs.
int kde_score_noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* kde_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
