// Device helpers shared by the port's graph kernels: the gather menu
// (repro_torch/kernels/ref.py::gather_msg), the reduce identities, the
// reduce combine, with the same arithmetic as the plain PyTorch versions,
// and the atomic combine of the order-free reduces.
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

// Would combining m into cur change it (min/max)?  NaN beats any number;
// nothing beats NaN; of +0 and -0 a min keeps -0 and a max +0 (the order
// -0 < +0), so that no result depends on the order of the combines.
template <typename T, int R>
__device__ __forceinline__ bool improves(T cur, T m) {
  if constexpr (std::is_floating_point<T>::value) {
    if (cur != cur) return false;
    if (m != m) return true;
    if (m == cur) {          // equal numbers differ in bits only as +-0
      const int mb = __float_as_int(m);
      const int cb = __float_as_int(cur);
      return R == kMin ? mb < cb : mb > cb;
    }
  }
  return R == kMin ? m < cur : m > cur;
}

// min and max propagate NaN, as torch.amin/amax and jnp.min/max do
// (fminf/fmaxf would drop it), and settle a tie of +0 and -0 as improves()
// does.
template <typename T, int R>
__device__ __forceinline__ T combine(T acc, T m) {
  if constexpr (R == kAdd) {
    return add_(acc, m);
  } else {
    return improves<T, R>(acc, m) ? m : acc;
  }
}

// Combine message m into *addr with an atomic, for the reduces a push or
// an order-free fold may run (min, max; add on int32 only); cur is a plain
// read of *addr made after the table's fill (possibly stale, never older
// than the fill).  Float min/max: a compare-and-swap loop that stores m
// while it still improves the word, so NaN propagates and a +0/-0 tie
// settles as combine() does, whatever order the atomics land in.
template <typename T, int R>
__device__ __forceinline__ void atomic_combine(T* addr, T m, T cur) {
  if constexpr (R == kAdd) {
    static_assert(!std::is_floating_point<T>::value,
                  "a float add depends on the order: no atomic fold");
    atomicAdd(addr, m);
  } else if constexpr (std::is_floating_point<T>::value) {
    // compare-and-swap on the bit patterns
    int* word = reinterpret_cast<int*>(addr);
    while (improves<T, R>(cur, m)) {
      const int seen =
          atomicCAS(word, __float_as_int(cur), __float_as_int(m));
      if (seen == __float_as_int(cur)) break;
      cur = __int_as_float(seen);
    }
  } else {
    if (improves<T, R>(cur, m)) {
      if constexpr (R == kMin) {
        atomicMin(addr, m);
      } else {
        atomicMax(addr, m);
      }
    }
  }
}

}  // namespace repro_torch
