// Device helpers shared by the port's graph kernels: the gather menu
// (repro_torch/kernels/ref.py::gather_msg), the reduce identities and the
// reduce combine, with the same arithmetic as the plain PyTorch versions.
//
// Float arithmetic goes through the _rn intrinsics so that nvcc never
// contracts a gather's multiply into the reduce's add (an FMA rounds
// once where the plain version rounds twice), and the division of
// div_deg is the IEEE-rounded one (the build never uses --use_fast_math).
// Integer add and multiply wrap modulo 2^32 like int32 tensors do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

constexpr int kPad = 0x7fffffff;  // PAD slot sentinel (int32 max)

enum GatherOp { kCopy = 0, kPlusOne = 1, kAddW = 2, kMulW = 3, kDivDeg = 4 };
enum ReduceOp { kAdd = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add_(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ int mul_(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// The weight is cast to the value type first, as `wgt.to(v.dtype)` does:
// float -> int32 truncates toward zero.
template <typename T, int G>
__device__ __forceinline__ T gather_op(T v, float w, int d) {
  if constexpr (G == kCopy) {
    return v;
  } else if constexpr (G == kPlusOne) {
    return add_(v, static_cast<T>(1));
  } else if constexpr (G == kAddW) {
    return add_(v, static_cast<T>(w));
  } else if constexpr (G == kMulW) {
    return mul_(v, static_cast<T>(w));
  } else {
    static_assert(G == kDivDeg, "unknown gather");
    return __fdiv_rn(v, static_cast<float>(d > 1 ? d : 1));
  }
}

template <typename T, int R>
__host__ __device__ __forceinline__ T reduce_identity() {
  if constexpr (R == kAdd) {
    return static_cast<T>(0);
  } else if constexpr (std::is_floating_point<T>::value) {
    return R == kMin ? INFINITY : -INFINITY;
  } else {
    return R == kMin ? static_cast<T>(0x7fffffff)
                     : static_cast<T>(-0x7fffffff - 1);
  }
}

// min and max propagate NaN, as torch.amin/amax and jnp.min/max do
// (fminf/fmaxf would drop it).
template <typename T, int R>
__device__ __forceinline__ T combine(T acc, T m) {
  if constexpr (R == kAdd) {
    return add_(acc, m);
  } else if constexpr (R == kMin) {
    return (acc < m || acc != acc) ? acc : m;
  } else {
    return (acc > m || acc != acc) ? acc : m;
  }
}

}  // namespace repro_torch
