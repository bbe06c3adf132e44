// Dense ELL gather-apply-reduce over a PAD-padded (R, W) neighbor block.
//
// Replaces the Pallas TPU kernel repro/kernels/edge_block.py::_kernel
// (dispatched by edge_block_reduce).  For each row: gather the value,
// out-degree and frontier bit of every neighbor slot, apply the menu
// gather, mask PAD and (with mask_inactive) inactive slots to the reduce
// identity, and reduce the row with add, min or max.  Outputs the (R,)
// reduced values and an (R,) any-live byte.  The plain version is
// repro_torch/kernels/ref.py::edge_block_reduce_ref.
//
// What bounds it on an H100: bytes, in two streams.  Every row streams W
// int32 ids once (and W float32 weights for the weighted gathers), and
// each live slot makes random reads of the frontier and value tables
// (and the degree table for div_deg).  On the main path the view is the
// flat width-8 pull view (W = 8, about 1.45 slots per edge); at Graph500
// scale 22 the vertex tables (~21 MB for bfs) fit in the 50 MB L2, so the
// random reads hit L2, but each costs a 32-byte sector for 1 or 4 useful
// bytes, and that L2 traffic, not the id stream from HBM, is what keeps
// the kernel several times above its HBM byte bound.
//
// Design: one thread per row, looping over its W slots in slot order, so
// a float add sums lanes 0..W-1 in order; the TPU version's VMEM tiling
// (block_rows) has no counterpart.  Dead slots (PAD or inactive) skip the
// value/degree reads entirely.  Tables are read through the read-only
// cache (__ldg).  Making it faster (a warp per group of rows, vector
// loads of the slot stream, L2-aware ordering) is later work.
//
// The block-skipping variant (kSkip) replaces the Pallas kernel
// repro/kernels/edge_block.py::_kernel_skip, dispatched when
// edge_block_reduce gets block_live=: rows come in blocks of block_rows,
// and a row whose block_live[r / block_rows] flag is 0 writes the reduce
// identity and any = 0 and returns before reading an id or a table.  It
// is bound by bytes too, but only the live blocks' id streams count: the
// ids of live blocks, the vertex tables, the (R / block_rows) flags and
// the two outputs over all R rows.  With block_rows >= 32 (the bitmap
// plane uses 128) a warp reads one flag, so a dead block costs one byte
// and two stores per row and nothing diverges; live rows run the body of
// kernel 1 unchanged.  Dead rows still take a thread each (the whole grid
// launches, as on the TPU); compacting live blocks into a smaller grid is
// later work.
#include "gather_ops.cuh"

namespace repro_torch {
namespace {

template <typename T, int G, int R, bool kMask, bool kSkip>
__global__ void edge_block_kernel(const uint8_t* __restrict__ block_live,
                                  long long block_rows,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ wgt,
                                  const T* __restrict__ values,
                                  const int* __restrict__ degrees,
                                  const uint8_t* __restrict__ active,
                                  T* __restrict__ out,
                                  uint8_t* __restrict__ any_out,
                                  long long rows, int width) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const T ident = reduce_identity<T, R>();
  if (kSkip && __ldg(block_live + r / block_rows) == 0) {
    out[r] = ident;
    any_out[r] = 0;
    return;
  }
  const int* row = nbr + r * width;
  const float* wrow = wgt + r * width;
  T acc = ident;
  bool any = false;
  for (int j = 0; j < width; ++j) {
    const int u = __ldg(row + j);
    bool live = u != kPad;
    if (kMask && live) live = __ldg(active + u) != 0;
    T m = ident;
    if (live) {
      const int d = G == kDivDeg ? __ldg(degrees + u) : 0;
      const float w = (G == kAddW || G == kMulW) ? __ldg(wrow + j) : 0.0f;
      m = gather_op<T, G>(__ldg(values + u), w, d);
      any = true;
    }
    acc = combine<T, R>(acc, m);
  }
  out[r] = acc;
  any_out[r] = any ? 1 : 0;
}

struct Args {
  const void* block_live;   // nullptr: no block skipping (kernel 1)
  long long block_rows;
  const void* nbr;
  const void* wgt;
  const void* values;
  const void* degrees;
  const void* active;
  void* out;
  void* any;
  long long rows;
  int width;
  cudaStream_t stream;
};

template <typename T, int G, int R, bool kMask, bool kSkip>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = 256;
  const long long blocks = (a.rows + kThreads - 1) / kThreads;
  edge_block_kernel<T, G, R, kMask, kSkip><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const uint8_t*>(a.block_live), a.block_rows,
      static_cast<const int*>(a.nbr), static_cast<const float*>(a.wgt),
      static_cast<const T*>(a.values), static_cast<const int*>(a.degrees),
      static_cast<const uint8_t*>(a.active), static_cast<T*>(a.out),
      static_cast<uint8_t*>(a.any), a.rows, a.width);
  return cudaGetLastError();
}

template <typename T, int G, int R, bool kMask>
cudaError_t by_skip(const Args& a) {
  return a.block_live ? launch<T, G, R, kMask, true>(a)
                      : launch<T, G, R, kMask, false>(a);
}

template <typename T, int G, int R>
cudaError_t by_mask(const Args& a, int mask) {
  return mask ? by_skip<T, G, R, true>(a) : by_skip<T, G, R, false>(a);
}

template <typename T, int G>
cudaError_t by_reduce(const Args& a, int reduce, int mask) {
  switch (reduce) {
    case kAdd: return by_mask<T, G, kAdd>(a, mask);
    case kMin: return by_mask<T, G, kMin>(a, mask);
    case kMax: return by_mask<T, G, kMax>(a, mask);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_gather(const Args& a, int gather, int reduce, int mask) {
  switch (gather) {
    case kCopy: return by_reduce<T, kCopy>(a, reduce, mask);
    case kPlusOne: return by_reduce<T, kPlusOne>(a, reduce, mask);
    case kAddW: return by_reduce<T, kAddW>(a, reduce, mask);
    case kMulW: return by_reduce<T, kMulW>(a, reduce, mask);
    case kDivDeg:
      // a true division: defined for float values only
      if constexpr (std::is_floating_point<T>::value) {
        return by_reduce<T, kDivDeg>(a, reduce, mask);
      } else {
        return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  value_is_float selects float32 (1) or
// int32 (0) values; a null block_live launches kernel 1, a non-null one
// the block-skipping variant over blocks of block_rows rows.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int edge_block_reduce_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    const void* block_live, long long block_rows, const void* nbr,
    const void* wgt, const void* values, const void* degrees,
    const void* active, void* out, void* any, long long rows, int width,
    void* stream) {
  using namespace repro_torch;
  if (block_live != nullptr && block_rows < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{block_live, block_rows, nbr, wgt, values, degrees, active,
               out, any, rows, width, static_cast<cudaStream_t>(stream)};
  return value_is_float ? by_gather<float>(a, gather, reduce, mask_inactive)
                        : by_gather<int>(a, gather, reduce, mask_inactive);
}
