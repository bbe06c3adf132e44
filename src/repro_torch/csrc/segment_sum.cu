// Segment add, min or max of a stream sorted by segment id.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_sum.py::_kernel
// (dispatched by segment_reduce).  Input: (E,) int32 segment ids sorted
// ascending, whose padded tail (if any) holds ids >= num_segments, and
// (E,) int32 or float32 values.  Output: (num_segments,) values, each the
// reduce of its segment's run, or the reduce identity for an empty
// segment (+inf/-inf for float min/max, INT_MAX/INT_MIN for int32, 0 for
// add).  The plain version is repro_torch/kernels/ref.py::
// segment_reduce_ref.
//
// What bounds it on an H100: bytes.  The function must read the E ids
// and E values once and write num_segments outputs: at the main shape
// (the reverse COO of Graph500 scale 22, E = 67.1M, V = 4.19M) that is
// about 0.55 GB, 0.16 ms at 3.35 TB/s.
//
// Design: one thread per output segment.  Two binary searches over the
// sorted ids (lower bounds of s and s+1) find the segment's run, and the
// thread reduces it in ascending element order, so a float add is
// deterministic and sums in the plain version's order; min and max
// propagate NaN (gather_ops.cuh's combine).  There is no scatter and no
// atomic.  The tail (ids >= num_segments) lies past every run and is
// never read.  The searches cost log2(E) ~ 26 dependent reads a thread,
// mostly L2 hits in the top levels.  Neighbouring threads read
// neighbouring runs, so the value stream coalesces where runs are short.
// A run is read eight values at a time (independent loads, then the
// combines in order) so that a long run is not one load latency per
// element; still, a hub segment of R-MAT gives one thread a long serial
// run, and its warp and the kernel's tail wait on it.  A warp per segment
// or a merge-path split of the edge stream is later work.
#include "gather_ops.cuh"

namespace repro_torch {
namespace {

// First index i in [0, n) with seg[i] >= key (n if none).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ seg,
                                                 long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(__ldg(seg + mid)) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

constexpr int kBatch = 8;

template <typename T, int R>
__global__ void segment_reduce_kernel(const int* __restrict__ seg,
                                      const T* __restrict__ val,
                                      T* __restrict__ out, long long n,
                                      long long num_segments) {
  const long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (s >= num_segments) return;
  const long long lo = lower_bound(seg, n, s);
  const long long hi = lower_bound(seg, n, s + 1);
  T acc = reduce_identity<T, R>();
  // eight independent loads in flight, then the combines in element order
  long long i = lo;
  for (; i + kBatch <= hi; i += kBatch) {
    T buf[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) buf[k] = __ldg(val + i + k);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc = combine<T, R>(acc, buf[k]);
  }
  for (; i < hi; ++i) acc = combine<T, R>(acc, __ldg(val + i));
  out[s] = acc;
}

template <typename T, int R>
cudaError_t launch(const void* seg, const void* val, void* out, long long n,
                   long long num_segments, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks = (num_segments + kThreads - 1) / kThreads;
  segment_reduce_kernel<T, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(seg), static_cast<const T*>(val),
      static_cast<T*>(out), n, num_segments);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_reduce(int reduce, const void* seg, const void* val,
                      void* out, long long n, long long num_segments,
                      cudaStream_t stream) {
  switch (reduce) {
    case kAdd: return launch<T, kAdd>(seg, val, out, n, num_segments, stream);
    case kMin: return launch<T, kMin>(seg, val, out, n, num_segments, stream);
    case kMax: return launch<T, kMax>(seg, val, out, n, num_segments, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  value_is_float selects float32 (1) or
// int32 (0) values.  Returns the cudaError_t of the launch (0 = success).
extern "C" int segment_reduce_launch(int device, int reduce,
                                     int value_is_float, const void* seg,
                                     const void* val, void* out, long long n,
                                     long long num_segments, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_is_float
             ? by_reduce<float>(reduce, seg, val, out, n, num_segments, s)
             : by_reduce<int>(reduce, seg, val, out, n, num_segments, s);
}
