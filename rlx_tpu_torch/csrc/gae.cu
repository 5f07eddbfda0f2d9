// Generalized Advantage Estimation: the reverse recurrence over T in one pass.
//
// Replaces rlx_tpu/ops/gae_pallas.py::gae_advantages_pallas (Pallas TPU).
//
//   delta[t] = r[t] + gamma * v'[t] * (1 - d[t]) - v[t]
//   adv[t]   = delta[t] + gamma * lambda * (1 - d[t]) * adv[t + 1]
//   ret[t]   = adv[t] + v[t]
//
// Bound: bytes.  Every input element is read once and every output element
// written once (4 f32 [T, B] reads counting the 1-byte terminations as 1/4,
// 2 f32 [T, B] writes); there are ~8 flops per element.
//
// Design: one thread per env column b, the running advantage in a register,
// t walked from T-1 down to 0.  Inputs are time-major [T, B] so at each t
// the 32 threads of a warp read 32 neighbouring floats of row t: every load
// and store is coalesced.  The bool/uint8 terminations are converted in the
// kernel (no extra pass), and the ragged edge b >= B is masked.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename TermT>
__global__ void gae_kernel(const float* __restrict__ rewards,
                           const float* __restrict__ values,
                           const float* __restrict__ next_values,
                           const TermT* __restrict__ terminations,
                           float* __restrict__ advantages,
                           float* __restrict__ returns,
                           int T, int B, float gamma, float gamma_lambda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float advantage = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * B + b;
    const float nonterminal = terminations[i] != TermT(0) ? 0.0f : 1.0f;
    const float value = values[i];
    const float delta = rewards[i] + gamma * next_values[i] * nonterminal - value;
    advantage = delta + gamma_lambda * nonterminal * advantage;
    advantages[i] = advantage;
    returns[i] = advantage + value;
  }
}

extern "C" int rlx_gae(const float* rewards, const float* values, const float* next_values,
                       const void* terminations, int terminations_are_float,
                       float* advantages, float* returns, int T, int B,
                       float gamma, float gamma_lambda, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 0) {
    if (terminations_are_float) {
      gae_kernel<float><<<blocks, threads, 0, s>>>(
          rewards, values, next_values, (const float*)terminations, advantages, returns,
          T, B, gamma, gamma_lambda);
    } else {
      gae_kernel<uint8_t><<<blocks, threads, 0, s>>>(
          rewards, values, next_values, (const uint8_t*)terminations, advantages, returns,
          T, B, gamma, gamma_lambda);
    }
  }
  return (int)cudaGetLastError();
}
