// Helpers of the FMA flash-attention kernels, the fp32 paths of
// flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu; their bf16
// tensor-core kernels use flash_sm90.cuh instead, and take only NEG_INF
// from here. fp32 conversion of the input dtype, the padded fp32 tile
// loader and the row reductions over the 8 lanes that share a row of a
// 64x64 tile.
//
// Every kernel keeps its tiles in shared memory as fp32 rows of D + 1
// floats: threads read a column of consecutive rows, and the pad puts
// those rows on distinct banks. The input dtype converts to fp32 exactly,
// so products from these tiles round only where the Pallas kernels round
// (their .astype calls), through round_to<T>.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // rows of every q, k and v tile
constexpr int NT = 128;             // threads: 16 row groups x 8 lanes
constexpr int RM = 4;               // tile rows per thread (TILE / 16)
constexpr int CN = 8;               // tile columns per thread (TILE / 8)
constexpr float NEG_INF = -1e30f;   // the Pallas kernels' mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the operand a product in T would see
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Copy rows [r0, r0 + TILE) of one head into a padded fp32 tile; rows past
// `len` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0,
                                          int len) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < len ? to_f(src[row * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float group_max(float x) {
  // the 8 lanes of a row group are neighbours: xor 1, 2, 4 stays inside it
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

}  // namespace
