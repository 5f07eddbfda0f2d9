// Categorical (C51) projection of a shifted support onto a fixed atom grid.
//
// Replaces rlx_tpu/ops/projection_pallas.py::categorical_projection_pallas
// (Pallas TPU).  Over rows n of the flattened leading dims:
//
//   b[n, j]   = (clip(z[n, j], v_min, v_max) - v_min) / delta_z
//   out[n, i] = sum_j clip(1 - |b[n, j] - i|, 0, 1) * p[n, j]
//
// with delta_z = (v_max - v_min) / (A_out - 1), rounded once to f32 on the
// host, and b computed with a true division (no reciprocal multiply), so the
// kernel and its plain PyTorch version round alike.
//
// Bound: bytes.  The function reads z and p once and writes out once:
// N * (2 * A_in + A_out) * 4 bytes, 9.93 MB at [8192, 101] -> 101, 2.96 us
// at the 3.35 TB/s of the H100 SXM data sheet (700 W).  The least work,
// each input mass split between its two neighbouring atoms, is ~10
// operations per input atom, far below the bytes.
//
// Design: a scatter, O(A_in + A_out) per row instead of the dense form's
// O(A_in * A_out).  Of the hat sum's A_in terms per output atom at most two
// are nonzero: input atom j lands on lo = floor(b) and lo + 1, with the
// weights the hat gives there (computed as the dense form computes them).
// An integral b puts all of its mass on lo (the lo + 1 weight is 0), and
// lo + 1 == A_out (b clipped at v_max) is never written.
// - One warp per row, 8 rows per 256-thread block; the ragged last block's
//   spare warps exit.  The lanes read z and p in chunks of 32 input atoms,
//   coalesced, 4 chunks at a time, and each lane computes its atom's lo and
//   two contributions in registers.
// - The row accumulates in [A_out] f32 of shared memory, zeroed first and
//   written out once, coalesced: shared memory scales with A_out (the
//   wrapper's geometry caps it), and A_in is not limited.
// - Deterministic, with no atomics: the same inputs give the same bits on
//   every launch.  Within a chunk the lanes' (lo, lane) keys are sorted
//   over the lanes (already sorted for the FastTD3 targets, whose
//   positions r + gamma * atoms increase with j; otherwise a bitonic sort
//   by shuffles), so lanes that share lo form runs of neighbouring lanes.
//   A segmented tree sum by shuffles leaves each run's two sums in its last
//   lane, which adds them, one atom per lane, to acc[lo] (with the previous
//   run's lo + 1 sum when that run sits on lo - 1) and acc[lo + 1].  The 4
//   chunks' shuffle chains run side by side; their adds go in j order with
//   __syncwarp() between.  A run is at most the 32 lanes of a chunk whose
//   positions all clip to one end of the support.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                  // rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;                 // 32-atom chunks taken together
constexpr size_t kMaxSharedBytes = 48 * 1024;

// -DRLX_TIMELINE (rlx_tpu_torch/benchmarks/kernel_timeline.py): lane 0 of
// each of the first kTimelineUnits warps (rows) writes the global timer
// (ns) at its start, when the adds' operands are ready (loads, sort check
// and run sums), after the adds and at its end, and its SM, to
// rlx_timeline; a no-op otherwise.
#ifdef RLX_TIMELINE
constexpr int kTimelineUnits = 65536;
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

// Sorts the warp's packed (key, lane) pairs ascending over the lanes
// (bitonic), carrying each pair's two contributions along.
__device__ __forceinline__ void warp_sort(int& packed, float& c_lo, float& c_hi, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(kFull, packed, j);
      const float other_lo = __shfl_xor_sync(kFull, c_lo, j);
      const float other_hi = __shfl_xor_sync(kFull, c_hi, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? other < packed : other > packed) {
        packed = other;
        c_lo = other_lo;
        c_hi = other_hi;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 8)
projection_kernel(const float* __restrict__ target_z, const float* __restrict__ probs,
                  float* __restrict__ out, int N, int A_in, int A_out,
                  float v_min, float v_max, float delta_z) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;  // the whole warp
  RLX_STAMP(lane == 0, row, 0);
  float* acc = smem + (size_t)warp * A_out;  // [A_out]
  for (int i = lane; i < A_out; i += 32) acc[i] = 0.0f;
  __syncwarp();

  const float* z_row = target_z + (size_t)row * A_in;
  const float* p_row = probs + (size_t)row * A_in;
  for (int base = 0; base < A_in; base += 32 * kChunks) {
    // Each step below runs over the kChunks chunks together, so their
    // shuffle chains overlap.  A lane past A_in takes key A_out, which
    // sorts last and is never written.
    // All the chunks' loads issue before any division, whose slow path is
    // a call the compiler does not hoist loads across.
    float z[kChunks], p[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = base + 32 * c + lane;
      z[c] = j < A_in ? z_row[j] : 0.0f;
      p[c] = j < A_in ? p_row[j] : 0.0f;
    }
    int packed[kChunks];
    float c_lo[kChunks], c_hi[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      // lo and the two contributions, with the hat weights the dense form
      // computes at lo and lo + 1
      const float b = (fminf(fmaxf(z[c], v_min), v_max) - v_min) / delta_z;
      const int lo = min(max((int)floorf(b), 0), A_out - 1);
      const float atom = (float)lo;
      c_lo[c] = fminf(fmaxf(1.0f - fabsf(b - atom), 0.0f), 1.0f) * p[c];
      c_hi[c] = fminf(fmaxf(1.0f - fabsf(b - (atom + 1.0f)), 0.0f), 1.0f) * p[c];
      const bool valid = base + 32 * c + lane < A_in;
      packed[c] = (valid ? lo : A_out) * 32 + lane;  // sorts by key, then lane
    }
    // Sorted positions (the FastTD3 targets' shifted atoms) skip the sort.
    int key[kChunks], key_before[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int before = __shfl_up_sync(kFull, packed[c], 1);
      if (__all_sync(kFull, lane == 0 || before < packed[c])) {
        key_before[c] = before >> 5;
      } else {
        warp_sort(packed[c], c_lo[c], c_hi[c], lane);
        key_before[c] = __shfl_up_sync(kFull, packed[c], 1) >> 5;
      }
      key[c] = packed[c] >> 5;
    }
    // Runs of equal keys: segmented inclusive sums over each run, in a
    // fixed tree order.  The run's last lane holds its sums.
    unsigned heads[kChunks];
    int start[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      heads[c] = __ballot_sync(kFull, lane == 0 || key[c] != key_before[c]);
      start[c] = 31 - __clz(heads[c] & ((2u << lane) - 1u));
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float lo_before = __shfl_up_sync(kFull, c_lo[c], d);
        const float hi_before = __shfl_up_sync(kFull, c_hi[c], d);
        if (lane - d >= start[c]) {
          c_lo[c] = lo_before + c_lo[c];
          c_hi[c] = hi_before + c_hi[c];
        }
      }
    }
    RLX_STAMP(lane == 0, row, 1);
    // One add per run and atom: atom key gets the previous run's lo + 1
    // sum (when that run's key is key - 1) with this run's lo sum; atom
    // key + 1 gets this run's lo + 1 sum unless the next run owns it.  The
    // runs' keys are distinct, so no two lanes touch one atom of a chunk;
    // the chunks add in j order, since two may touch one atom.
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int prev = max(start[c] - 1, 0);
      const int prev_key = __shfl_sync(kFull, key[c], prev);
      const float prev_hi = __shfl_sync(kFull, c_hi[c], prev);
      const int next_key = __shfl_down_sync(kFull, key[c], 1);
      const bool tail = lane == 31 || ((heads[c] >> (lane + 1)) & 1u);
      const int k = key[c];
      if (tail && k < A_out) {
        acc[k] += start[c] > 0 && prev_key == k - 1 ? prev_hi + c_lo[c] : c_lo[c];
        if (k + 1 < A_out && !(lane < 31 && next_key == k + 1)) acc[k + 1] += c_hi[c];
      }
      __syncwarp();
    }
    RLX_STAMP(lane == 0, row, 2);
  }
  float* out_row = out + (size_t)row * A_out;
  for (int i = lane; i < A_out; i += 32) out_row[i] = acc[i];
  RLX_STAMP(lane == 0, row, 3);
}

}  // namespace

// The launch shape comes from the wrapper (ops/projection_cuda.py::
// projection_geometry); it is checked against this kernel's here.
extern "C" int rlx_categorical_projection(const float* target_z, const float* probs, float* out,
                                          int N, int A_in, int A_out,
                                          float v_min, float v_max, float delta_z,
                                          int blocks, int threads, int shared_bytes,
                                          void* stream) {
  const size_t need = (size_t)kWarps * A_out * sizeof(float);
  if (A_out < 2 || threads != kThreads || (size_t)shared_bytes != need ||
      need > kMaxSharedBytes || (long long)blocks * kWarps < N) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks > 0) {
    projection_kernel<<<blocks, kThreads, need, (cudaStream_t)stream>>>(
        target_z, probs, out, N, A_in, A_out, v_min, v_max, delta_z);
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
