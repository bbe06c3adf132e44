// Segment add, min or max of a stream sorted by segment id.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_sum.py::_kernel
// (dispatched by segment_reduce).  Input: (E,) int32 segment ids sorted
// ascending, whose padded tail (if any) holds ids >= num_segments, and
// (E,) int32 or float32 values.  Output: (num_segments,) values, each the
// reduce of its segment's run, or the reduce identity for an empty
// segment (+inf/-inf for float min/max, INT_MAX/INT_MIN for int32, 0 for
// add).  Ids outside [0, num_segments) are dropped.  The plain version is
// repro_torch/kernels/ref.py::segment_reduce_ref.
//
// What bounds it on an H100: bytes.  The function must read the E ids
// and E values once and write num_segments outputs: at the main shape
// (the reverse COO of Graph500 scale 22, E = 67.1M, V = 4.19M) that is
// about 0.55 GB, 0.16 ms at 3.35 TB/s.
//
// Design: an edge-balanced tiled segmented reduction in three launches.
// The TPU kernel keeps one accumulator resident across a sequential grid;
// Hopper's blocks run in no order, and a block per run of segments would
// hand R-MAT's hub (160,549 elements) to one thread, so the work is cut
// by elements instead:
// 1. A fill writes the identity to every output, so a segment that gets
//    no element keeps it.
// 2. The tile kernel gives each block a tile of kTile = 256 threads x 8
//    contiguous elements, each thread's ids and values read as two 16-byte
//    loads.  A thread reduces the runs among its 8 elements and writes
//    those that start and end inside it; a block-wide segmented scan over
//    (run head seen, partial) pairs (warp shuffles, then the 8 warp totals
//    through shared memory) carries each thread's open run in from the
//    threads before it.  A run that ends inside the tile and did not come
//    from the previous tile is written to out; the tile's first run, when
//    it continues from the previous tile, and its last run, when it
//    continues into the next, go to per-tile carries (first and last
//    partial, and flags: single run, continues from previous, continues
//    into next), from which the one run that crosses a boundary is
//    finished later.  Every element is read once, and no thread holds
//    more than 8 of them.
// 3. The fold kernel, one thread per tile, finishes each run that crosses
//    tiles: the tile where it starts folds the carries in tile order (its
//    last partial, then each next tile's first partial) until the tile
//    where it ends, 16 carries in flight at a time, and writes out.  The
//    hub spans about 79 tiles, 5 rounds of loads.  There are no atomics.
// The order of a float add is fixed by the tile shape (a thread's
// elements in order, then the scan's tree, then the carries in tile
// order), so it is the same on every run, but it is not the element
// order of the plain version: they agree within rtol 1e-5.  Min and max
// propagate NaN, also through a carry (gather_ops.cuh's combine).
#include "gather_ops.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldBatch = 16;

// per-tile carry flags
enum TileFlag { kSingle = 1, kContPrev = 2, kContNext = 4 };

// One step of the segmented scan: the right pair's partial restarts
// where it saw a run head, else it extends the left pair's.
template <typename T, int R>
__device__ __forceinline__ void scan_op(bool lf, T la, bool& rf, T& ra) {
  if (!rf) ra = combine<T, R>(la, ra);
  rf = lf || rf;
}

template <typename T>
__global__ void segment_fill_kernel(T* __restrict__ out, T value,
                                    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = value;
  }
}

// Where a finished run goes: the tile's first run when it came from the
// previous tile, or its last when it goes on into the next, to the
// carries; any other to out (unless its id is dropped).  The thread that
// ends the tile's last run writes the tile's flags.
template <typename T>
__device__ __forceinline__ void finish_run(
    int key, T agg, bool starts_tile, bool ends_tile, bool cont_prev,
    bool cont_next, long long tile, T* __restrict__ out,
    T* __restrict__ carry_first, T* __restrict__ carry_last,
    int* __restrict__ flags, long long S) {
  const bool to_first = starts_tile && cont_prev;
  const bool to_last = ends_tile && cont_next;
  if (to_first) carry_first[tile] = agg;
  if (to_last) carry_last[tile] = agg;
  if (!to_first && !to_last && key >= 0 && key < S) out[key] = agg;
  if (ends_tile) {
    flags[tile] = (starts_tile ? kSingle : 0) | (cont_prev ? kContPrev : 0) |
                  (cont_next ? kContNext : 0);
  }
}

template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
    segment_tile_kernel(const int* __restrict__ seg,
                        const T* __restrict__ val, T* __restrict__ out,
                        T* __restrict__ carry_first,
                        T* __restrict__ carry_last, int* __restrict__ flags,
                        long long n, long long S) {
  __shared__ int s_first[kThreads];   // each thread's first id
  __shared__ int s_last[kThreads];    // each thread's last id
  __shared__ bool s_wf[kWarps];       // each warp's scan total
  __shared__ T s_wa[kWarps];
  __shared__ bool s_cont[2];          // continues from previous / into next

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const long long tile_end = min(base + kTile, n);
  const long long i0 = base + static_cast<long long>(t) * kItems;

  int k[kItems];
  T v[kItems];
  if (kVec && i0 + kItems <= n) {
    const int4* sp = reinterpret_cast<const int4*>(seg + i0);
    const int4 a = __ldcs(sp), b = __ldcs(sp + 1);
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
    if constexpr (std::is_floating_point<T>::value) {
      const float4* vp = reinterpret_cast<const float4*>(val + i0);
      const float4 c = __ldcs(vp), d = __ldcs(vp + 1);
      v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
      v[4] = d.x; v[5] = d.y; v[6] = d.z; v[7] = d.w;
    } else {
      const int4* vp = reinterpret_cast<const int4*>(val + i0);
      const int4 c = __ldcs(vp), d = __ldcs(vp + 1);
      v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
      v[4] = d.x; v[5] = d.y; v[6] = d.z; v[7] = d.w;
    }
  } else {
    // past E: a key of its own, unequal to the stream's last id and
    // outside [0, S), so those elements form a run that is never written
    const int last = n > 0 ? __ldg(seg + n - 1) : 0;
    const int beyond = last == -1 ? -2 : -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = i0 + j;
      k[j] = i < n ? __ldg(seg + i) : beyond;
      v[j] = i < n ? __ldg(val + i) : reduce_identity<T, R>();
    }
  }
  s_first[t] = k[0];
  s_last[t] = k[kItems - 1];
  if (t == 0) {
    s_cont[0] = base > 0 && __ldg(seg + base - 1) == k[0];
    s_cont[1] = tile_end < n &&
                __ldg(seg + tile_end) == __ldg(seg + tile_end - 1);
  }
  __syncthreads();
  const bool cont_prev = s_cont[0];
  const bool cont_next = s_cont[1];
  const long long last_i = tile_end - 1;

  // this thread's runs: interior ones (a head on both sides) are finished
  // now; the first run (up to the first head) and the last (from the last
  // head) stay open
  bool head_in = false;          // a run head at positions 1..7
  int first_end = kItems - 1;    // position of the first run's last element
  T first_agg, acc = v[0];
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    if (k[j] != k[j - 1]) {
      if (!head_in) {
        first_agg = acc;
        first_end = j - 1;
        head_in = true;
      } else {
        // starts after this thread's first element, so it is not the
        // tile's first run; it is the tile's last only in the last tile
        finish_run<T>(k[j - 1], acc, false, i0 + j - 1 == last_i,
                      cont_prev, cont_next, tile, out, carry_first,
                      carry_last, flags, S);
      }
      acc = v[j];
    } else {
      acc = combine<T, R>(acc, v[j]);
    }
  }
  if (!head_in) first_agg = acc;
  const bool head0 = t > 0 && k[0] != s_last[t - 1];   // head at position 0

  // block-wide exclusive segmented scan of (head seen, last run's partial)
  bool f = head_in || head0;
  T a = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool fo = __shfl_up_sync(~0u, f, o);
    const T ao = __shfl_up_sync(~0u, a, o);
    if (lane >= o) scan_op<T, R>(fo, ao, f, a);
  }
  if (lane == 31) {
    s_wf[warp] = f;
    s_wa[warp] = a;
  }
  __syncthreads();
  bool pf = false;
  T pa = reduce_identity<T, R>();
  if (warp > 0) {
    pf = s_wf[0];
    pa = s_wa[0];
    for (int w = 1; w < warp; ++w) {
      bool wf = s_wf[w];
      T wa = s_wa[w];
      scan_op<T, R>(pf, pa, wf, wa);
      pf = wf;
      pa = wa;
    }
    scan_op<T, R>(pf, pa, f, a);     // inclusive through this thread
  }
  bool ef = __shfl_up_sync(~0u, f, 1);
  T ea = __shfl_up_sync(~0u, a, 1);
  if (lane == 0) {
    ef = pf;
    ea = pa;
  }
  // ef: a head lies between the tile's start and this thread; ea: the
  // partial of the run open at the end of thread t - 1

  const bool carried = t > 0 && !head0;           // first run comes in
  const bool first_starts_tile = t == 0 || (carried && !ef);
  const T first_full = carried ? combine<T, R>(ea, first_agg) : first_agg;
  // does the run open at position 7 end here?
  const bool ends7 = t == kThreads - 1 || s_first[t + 1] != k[kItems - 1];
  if (i0 < n) {
    if (head_in) {
      finish_run<T>(k[0], first_full, first_starts_tile,
                    i0 + first_end == last_i, cont_prev, cont_next, tile,
                    out, carry_first, carry_last, flags, S);
      if (ends7) {
        finish_run<T>(k[kItems - 1], acc, false,
                      i0 + kItems - 1 == last_i, cont_prev, cont_next,
                      tile, out, carry_first, carry_last, flags, S);
      }
    } else if (ends7) {
      finish_run<T>(k[0], first_full, first_starts_tile,
                    i0 + kItems - 1 == last_i, cont_prev, cont_next, tile,
                    out, carry_first, carry_last, flags, S);
    }
  }
}

// One thread per tile: a tile whose last run goes on into the next tile,
// and did not itself come from the previous one, folds that run's
// carries in tile order and writes it.
template <typename T, int R>
__global__ void segment_fold_kernel(const int* __restrict__ seg,
                                    const T* __restrict__ carry_first,
                                    const T* __restrict__ carry_last,
                                    const int* __restrict__ flags,
                                    T* __restrict__ out, long long tiles,
                                    long long S) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= tiles) return;
  const int fb = flags[b];
  if (!(fb & kContNext)) return;
  if ((fb & kSingle) && (fb & kContPrev)) return;   // inside a chain
  const int key = __ldg(seg + (b + 1) * kTile);      // the run's id
  if (key < 0 || key >= S) return;
  T acc = carry_last[b];
  for (long long j = b + 1; j < tiles; j += kFoldBatch) {
    int fl[kFoldBatch];
    T cf[kFoldBatch];
#pragma unroll
    for (int m = 0; m < kFoldBatch; ++m) {
      if (j + m < tiles) {
        fl[m] = flags[j + m];
        cf[m] = carry_first[j + m];
      }
    }
#pragma unroll
    for (int m = 0; m < kFoldBatch; ++m) {
      if (j + m >= tiles) break;
      acc = combine<T, R>(acc, cf[m]);
      if (!((fl[m] & kSingle) && (fl[m] & kContNext))) {
        out[key] = acc;                 // tile j + m ends the run
        return;
      }
    }
  }
  out[key] = acc;
}

template <typename T, int R>
cudaError_t launch(const void* seg, const void* val, void* out,
                   void* carry_first, void* carry_last, void* flags,
                   long long n, long long S, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  const long long fill_blocks =
      S < 256LL * 132 * 16 ? (S + 255) / 256 : 132LL * 16;
  segment_fill_kernel<T><<<fill_blocks, 256, 0, stream>>>(
      o, reduce_identity<T, R>(), S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  const long long tiles = (n + kTile - 1) / kTile;
  const int* s = static_cast<const int*>(seg);
  const T* v = static_cast<const T*>(val);
  T* cf = static_cast<T*>(carry_first);
  T* cl = static_cast<T*>(carry_last);
  int* fl = static_cast<int*>(flags);
  const bool vec = reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0;
  if (vec) {
    segment_tile_kernel<T, R, true><<<tiles, kThreads, 0, stream>>>(
        s, v, o, cf, cl, fl, n, S);
  } else {
    segment_tile_kernel<T, R, false><<<tiles, kThreads, 0, stream>>>(
        s, v, o, cf, cl, fl, n, S);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  segment_fold_kernel<T, R><<<(tiles + 255) / 256, 256, 0, stream>>>(
      s, cf, cl, fl, o, tiles, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_reduce(int reduce, const void* seg, const void* val,
                      void* out, void* cf, void* cl, void* flags, long long n,
                      long long S, cudaStream_t stream) {
  switch (reduce) {
    case kAdd:
      return launch<T, kAdd>(seg, val, out, cf, cl, flags, n, S, stream);
    case kMin:
      return launch<T, kMin>(seg, val, out, cf, cl, flags, n, S, stream);
    case kMax:
      return launch<T, kMax>(seg, val, out, cf, cl, flags, n, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  value_is_float selects float32 (1) or
// int32 (0) values.  carry_first and carry_last hold one value and flags
// one int32 for each of the `tiles` tiles of kTile (2048) elements, scratch
// the caller allocates; too few for n elements is refused.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int segment_reduce_launch(int device, int reduce,
                                     int value_is_float, const void* seg,
                                     const void* val, void* out,
                                     void* carry_first, void* carry_last,
                                     void* flags, long long tiles,
                                     long long n, long long num_segments,
                                     void* stream) {
  using namespace repro_torch;
  if (tiles * kTile < n) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_is_float
             ? by_reduce<float>(reduce, seg, val, out, carry_first,
                                carry_last, flags, n, num_segments, s)
             : by_reduce<int>(reduce, seg, val, out, carry_first, carry_last,
                              flags, n, num_segments, s);
}
