// Shared device helpers for the hand-written Hopper kernels of repro_torch.
//
// Every reduction here has a FIXED shape: a per-thread loop at a fixed
// stride, a warp-shuffle tree, then a tree over the block's warps in shared
// memory.  No float atomics are used anywhere, so a kernel gives the same
// bits for the same inputs on every run, and an extra all-masked tile is an
// exact no-op.  That is what the frame layer's bit-for-bit contracts
// (batched == unbatched, fused == unfused, progressive == blocking) rest on.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

struct SumF { __device__ static float id() { return 0.0f; } __device__ static float op(float a, float b) { return a + b; } };
struct MinF { __device__ static float id() { return CUDART_INF_F; } __device__ static float op(float a, float b) { return fminf(a, b); } };
struct MaxF { __device__ static float id() { return -CUDART_INF_F; } __device__ static float op(float a, float b) { return fmaxf(a, b); } };

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Op::op(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long warp_reduce_ll(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction with a fixed tree; the result is returned to EVERY
// thread.  `scratch` needs one slot per warp (<= 32).  Must be called by all
// threads of the block.
template <typename Op>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_reduce<Op>(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : Op::id();
    w = warp_reduce<Op>(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

__device__ long long block_reduce_ll(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_reduce_ll(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? scratch[lane] : 0;
    w = warp_reduce_ll(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace repro
