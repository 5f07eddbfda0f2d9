// Generalized Advantage Estimation: the reverse recurrence over T in one pass.
//
// Replaces rlx_tpu/ops/gae_pallas.py::gae_advantages_pallas (Pallas TPU).
//
//   delta[t] = r[t] + gamma * v'[t] * (1 - d[t]) - v[t]
//   adv[t]   = delta[t] + gamma * lambda * (1 - d[t]) * adv[t + 1]
//   ret[t]   = adv[t] + v[t]
//
// Bound: bytes.  Every input element is read once and every output element
// written once (3 f32 [T, B] inputs and the 1-byte terminations, 2 f32
// [T, B] outputs: 5.5 MB at [64, 4096], 1.64 us at the 3.35 TB/s of the
// H100 SXM data sheet, 700 W); there are ~8 flops per element.
//
// Design: one block of 16 warps per 32 env columns (one 128-byte segment of
// a time-major row), so B=4096 gives 128 blocks, one wave over 132 SMs.
// Time is taken in chunks of kChunk rows from the end; the carry passes to
// the next, earlier chunk, so any T is allowed.  For each chunk:
// - Staging: every warp loads its rows of r, v, v' and the terminations
//   into registers with coalesced loads, all before any is used, so the
//   chunk's loads are in flight at once; it stores delta and gamma lambda
//   (1 - d) into shared memory and keeps v.  Rows before t = 0 (the
//   earliest chunk may be partial) stage as delta 0.
// - Walk: warp 0, one env column a lane, runs adv = delta + coef * adv from
//   the chunk's last row to its first, the carry in a register, in batches
//   of kBatch rows held in registers; the next batch's shared-memory loads
//   issue before this batch's dependent multiply-adds.  The operation order
//   is the plain version's, so no time-parallel scan (it would round
//   otherwise).  adv goes back over delta.
// - Stores: every warp stores adv and adv + v of its rows, coalesced.
// The bool/uint8 or float terminations are converted while staging, and
// columns b >= B are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                   // env columns per block
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;                  // time rows per staged chunk
constexpr int kRowsPerWarp = kChunk / kWarps;
constexpr int kBatch = 16;                  // slots of the walk in registers at once
constexpr int kSharedBytes = 2 * kChunk * kCols * sizeof(float);

// -DRLX_TIMELINE (rlx_tpu_torch/benchmarks/kernel_timeline.py): one thread
// of each of the first kTimelineUnits blocks writes the global timer (ns)
// at its start, after the staging, after the walk and at its end, and its
// SM, to rlx_timeline; a no-op otherwise.
#ifdef RLX_TIMELINE
constexpr int kTimelineUnits = 16384;
__device__ unsigned long long rlx_timeline[5 * kTimelineUnits];
#define RLX_STAMP(on, unit, k)                                                  \
  if ((on) && (unit) < kTimelineUnits) {                                        \
    unsigned long long t_;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
    rlx_timeline[5 * (unit) + (k)] = t_;                                        \
    if ((k) == 3) {                                                             \
      unsigned sm_;                                                             \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                          \
      rlx_timeline[5 * (unit) + 4] = sm_;                                       \
    }                                                                           \
  }
#else
#define RLX_STAMP(on, unit, k)
#endif

template <typename TermT>
__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ rewards, const float* __restrict__ values,
           const float* __restrict__ next_values, const TermT* __restrict__ terminations,
           float* __restrict__ advantages, float* __restrict__ returns,
           int T, int B, float gamma, float gamma_lambda) {
  extern __shared__ float smem[];
  float* delta_s = smem;                     // [kChunk, kCols]; adv after the walk
  float* coef_s = delta_s + kChunk * kCols;  // [kChunk, kCols]: gamma lambda (1 - d)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCols + lane;
  const bool in = b < B;
  float advantage = 0.0f;  // warp 0's carry
  RLX_STAMP(threadIdx.x == 0, blockIdx.x, 0);

  for (int end = T; end > 0; end -= kChunk) {
    const int slot0 = end - kChunk;  // row t sits in slot t - slot0
    float r[kRowsPerWarp], v[kRowsPerWarp], nv[kRowsPerWarp], nt[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int t = slot0 + warp + k * kWarps;
      r[k] = v[k] = nv[k] = 0.0f;
      nt[k] = 1.0f;
      if (in && t >= 0) {
        const size_t i = (size_t)t * B + b;
        r[k] = rewards[i];
        v[k] = values[i];
        nv[k] = next_values[i];
        nt[k] = terminations[i] != TermT(0) ? 0.0f : 1.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int s = (warp + k * kWarps) * kCols + lane;
      delta_s[s] = r[k] + gamma * nv[k] * nt[k] - v[k];
      coef_s[s] = gamma_lambda * nt[k];
    }
    __syncthreads();
    RLX_STAMP(threadIdx.x == 0, blockIdx.x, 1);

    if (warp == 0) {
      // The walk, in batches of kBatch slots held in registers: the next
      // batch's loads issue before this batch's multiply-add chain.  Slots
      // that hold no row (the earliest chunk's) have delta 0 and are never
      // stored; the carry they leave is not used.
      float delta[kBatch], coef[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        delta[k] = delta_s[(kChunk - kBatch + k) * kCols + lane];
        coef[k] = coef_s[(kChunk - kBatch + k) * kCols + lane];
      }
#pragma unroll
      for (int top = kChunk; top > 0; top -= kBatch) {
        float next_delta[kBatch], next_coef[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const bool more = top > kBatch;
          next_delta[k] = more ? delta_s[(top - 2 * kBatch + k) * kCols + lane] : 0.0f;
          next_coef[k] = more ? coef_s[(top - 2 * kBatch + k) * kCols + lane] : 0.0f;
        }
#pragma unroll
        for (int k = kBatch - 1; k >= 0; --k) {
          advantage = delta[k] + coef[k] * advantage;
          delta_s[(top - kBatch + k) * kCols + lane] = advantage;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          delta[k] = next_delta[k];
          coef[k] = next_coef[k];
        }
      }
    }
    __syncthreads();
    RLX_STAMP(threadIdx.x == 0, blockIdx.x, 2);

#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int t = slot0 + warp + k * kWarps;
      if (in && t >= 0) {
        const size_t i = (size_t)t * B + b;
        const float adv = delta_s[(warp + k * kWarps) * kCols + lane];
        advantages[i] = adv;
        returns[i] = adv + v[k];
      }
    }
    __syncthreads();  // the next chunk's staging overwrites the slots
  }
  RLX_STAMP(threadIdx.x == 0, blockIdx.x, 3);
}

}  // namespace

// The launch shape comes from the wrapper (ops/gae_cuda.py::gae_geometry);
// it is checked against this kernel's here.
extern "C" int rlx_gae(const float* rewards, const float* values, const float* next_values,
                       const void* terminations, int terminations_are_float,
                       float* advantages, float* returns, int T, int B,
                       float gamma, float gamma_lambda,
                       int blocks, int threads, int shared_bytes, void* stream) {
  if (threads != kThreads || shared_bytes != kSharedBytes || (long long)blocks * kCols < B) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0 && T > 0) {
    if (terminations_are_float) {
      gae_kernel<float><<<blocks, kThreads, kSharedBytes, s>>>(
          rewards, values, next_values, (const float*)terminations, advantages, returns,
          T, B, gamma, gamma_lambda);
    } else {
      gae_kernel<uint8_t><<<blocks, kThreads, kSharedBytes, s>>>(
          rewards, values, next_values, (const uint8_t*)terminations, advantages, returns,
          T, B, gamma, gamma_lambda);
    }
  }
  return (int)cudaGetLastError();
}

#ifdef RLX_TIMELINE
// Copies the first `units` records of the timeline out (synchronous).
extern "C" int rlx_timeline_read(unsigned long long* out, int units) {
  const size_t n = 5 * (size_t)(units < kTimelineUnits ? units : kTimelineUnits);
  return (int)cudaMemcpyFromSymbol(out, rlx_timeline, n * sizeof(unsigned long long));
}
#endif
