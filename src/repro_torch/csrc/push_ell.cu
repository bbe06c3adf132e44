// Message stage of the frontier-compacted forward-ELL push superstep.
//
// Replaces the Pallas TPU kernel repro/kernels/push_ell.py::_message_kernel
// (dispatched by push_ell_message_block).  For each compacted row c and
// slot j: msg[c, j] = gather(values[src[c]], wgt[c, j], degrees[src[c]]).
// PAD masking and the scatter-combine stay outside, as on the TPU
// (repro_torch/kernels/push_ell.py::compacted_push_reduce).  The plain
// version is push_ell_message_block_plain in the same module.
//
// What bounds it on an H100: bytes.  It streams the (C, W) float32
// weights in and the (C, W) messages out, plus one source id and one
// random value (and degree, for div_deg) read per row; the vertex tables
// sit in L2 at the main path's sizes.
//
// Design: one thread per (row, slot), so both streams are coalesced; the
// W threads of a row read the same source id and value, which the
// hardware serves as one broadcast load per warp segment.
#include "gather_ops.cuh"

namespace repro_torch {
namespace {

template <typename T, int G>
__global__ void push_ell_message_kernel(const float* __restrict__ wgt,
                                        const int* __restrict__ src,
                                        const T* __restrict__ values,
                                        const int* __restrict__ degrees,
                                        T* __restrict__ out,
                                        long long rows, int width) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows * width) return;
  const int s = __ldg(src + i / width);
  const int d = G == kDivDeg ? __ldg(degrees + s) : 0;
  const float w = (G == kAddW || G == kMulW) ? __ldg(wgt + i) : 0.0f;
  out[i] = gather_op<T, G>(__ldg(values + s), w, d);
}

template <typename T, int G>
cudaError_t launch(const void* wgt, const void* src, const void* values,
                   const void* degrees, void* out, long long rows, int width,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long n = rows * width;
  const long long blocks = (n + kThreads - 1) / kThreads;
  push_ell_message_kernel<T, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(wgt), static_cast<const int*>(src),
      static_cast<const T*>(values), static_cast<const int*>(degrees),
      static_cast<T*>(out), rows, width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_gather(int gather, const void* wgt, const void* src,
                      const void* values, const void* degrees, void* out,
                      long long rows, int width, cudaStream_t stream) {
  switch (gather) {
    case kCopy:
      return launch<T, kCopy>(wgt, src, values, degrees, out, rows, width,
                              stream);
    case kPlusOne:
      return launch<T, kPlusOne>(wgt, src, values, degrees, out, rows, width,
                                 stream);
    case kAddW:
      return launch<T, kAddW>(wgt, src, values, degrees, out, rows, width,
                              stream);
    case kMulW:
      return launch<T, kMulW>(wgt, src, values, degrees, out, rows, width,
                              stream);
    case kDivDeg:
      // a true division: defined for float values only
      if constexpr (std::is_floating_point<T>::value) {
        return launch<T, kDivDeg>(wgt, src, values, degrees, out, rows,
                                  width, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  value_is_float selects float32 (1) or
// int32 (0) values.  Returns the cudaError_t of the launch (0 = success).
extern "C" int push_ell_message_launch(int device, int gather,
                                       int value_is_float, const void* wgt,
                                       const void* src, const void* values,
                                       const void* degrees, void* out,
                                       long long rows, int width,
                                       void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_is_float
             ? by_gather<float>(gather, wgt, src, values, degrees, out, rows,
                                width, s)
             : by_gather<int>(gather, wgt, src, values, degrees, out, rows,
                              width, s);
}
