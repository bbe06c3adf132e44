// The frontier-compacted forward-ELL push superstep: its message stage,
// and the message stage fused with the combine.
//
// 1. push_ell_message_kernel replaces the Pallas TPU kernel
// repro/kernels/push_ell.py::_message_kernel (dispatched by
// push_ell_message_block).  For each compacted row c and slot j:
// msg[c, j] = gather(values[src[c]], wgt[c, j], degrees[src[c]]).  PAD
// masking and the scatter-combine stay outside, as on the TPU.  The
// plain version is push_ell_message_block_plain in
// repro_torch/kernels/push_ell.py.
//
// What bounds it on an H100: bytes.  It streams the (C, W) float32
// weights in and the (C, W) messages out, plus one source id and one
// random value (and degree, for div_deg) read per row; the vertex tables
// sit in L2 at the main path's sizes.
//
// Design: one thread per (row, slot), so both streams are coalesced; the
// W threads of a row read the same source id and value, which the
// hardware serves as one broadcast load per warp segment.
//
// 2. push_ell_fused_kernel is the whole superstep reduce after the
// compaction, which the translator's push path launches in place of (1)
// and the combine: the TPU kernel left its combine to XLA's segment
// reduce, because a data-dependent scatter does not map onto a dense TPU
// grid (repro/kernels/push_ell.py, compacted_push_reduce); on Hopper it
// maps onto atomics.  For each compacted row c with ok[c], the row
// r = sel[c] of the forward ELL is read in place (no (C, W) copy of its
// ids, weights or sources, and no messages in memory): its source's value
// (and degree) once, then for each slot whose id is a vertex (not PAD)
// the menu gather, combined into the identity-filled (V,) table with an
// atomic, and with a touched table, a plain store of 1.  The plain
// version is push_ell_fused_reduce_plain (messages, then
// scatter_reduce_).  Push is legal only for min, max and integer add, so
// the atomics give the plain version's result in any order:
// - int32 min/max: a plain read of the word (through L2, the
//   test-before-atomic) and atomicMin/atomicMax only when the message
//   would change it.  The table only moves one way, so a stale read can
//   cost an atomic but never skip a needed one.  In a BFS superstep every
//   message carries the same level, so most messages to a hub find it
//   already written and issue nothing.
// - float32 min/max: the same test, then a compare-and-swap loop that
//   stores the message while it still improves the word: smaller (min) or
//   larger (max), or NaN over a number, so NaN propagates as
//   gather_ops.cuh's combine does and +0 and -0 count as equal.
// - int32 add: atomicAdd, which wraps modulo 2^32 like the plain sum.
// Float add is refused.
//
// What bounds it: bytes.  The function must read the compacted rows' ids
// (sel and ok, then W ids a live row), one source id and value (and
// degree, for div_deg) a row, the weights only for add_w and mul_w, and
// write the table's fill and one word a valid slot.  The table (16.8 MB
// at scale 22) stays in L2, where the reads and atomics land.
//
// Design: one thread per compacted row, so the source is read once a
// row; at W = 8 (the width every caller passes) a row's ids, and weights
// where used, come as two 16-byte loads, then the row's 8 table reads are
// issued together before its atomics.
//
// 3. push_ell_lanes_kernel (3L) is the push superstep over k lanes at once,
// the counterpart of the same Pallas call under jax.vmap in the JAX
// package's batched runs (repro/core/translator.py, run_batch), with its
// combine.  It needs no compaction: push is legal only for min, max and
// integer add, so its combine is exact in any order and rows need not be
// visited in storage order.  A pre-pass (lanes.cuh, lanes_pack_kernel
// without messages) packs the pushing lanes' frontier bits vertex-major,
// K bits a vertex.  Then one thread takes each forward-ELL row: it reads
// row_src and that source's K lane bits, and stops when none is set;
// otherwise it reads the row's ids once (two 16-byte loads at W = 8) and,
// for each live lane in turn, the source's value in that lane (through the
// lane map, in place in the (k', V) state), the menu gather, and for each
// slot whose id is a vertex a plain test read and an atomic combine into
// the lane's row of the (k', V) identity-filled table, as the fused kernel
// does.  Each lane's messages are those the fused kernel computes for that
// lane alone, with the same arithmetic, so each lane's table equals its
// compacted push's bit for bit (both settle a float +0/-0 tie in
// atomic_combine, a min keeping -0 and a max +0, in any order).  The
// streamed engine's push partitions (repro/core/stream.py's push partial,
// jax.ops.segment_* over each partition's forward ELL) run 3L over each
// partition's rows into the running (k', V) table, whose atomics combine
// any partials already there, and a got table that takes a plain store of
// 1 for each message that lands (the JAX package's segment_max(live) > 0);
// the pre-pass runs once a superstep (Stage in lanes.cuh).
//
// What bounds 3L: bytes.  It must read row_src (R x 4 B, 50 MB at scale
// 22), each pushing lane's frontier (k x V B, in the pre-pass) and the
// bits it packs, then for each live row its W ids, and for each live
// (row, lane) the source's value, and write one word a valid slot and live
// lane, besides the table's fill.  On a narrow frontier the row_src scan
// and the pre-pass are nearly all of it; that scan replaces k compactions
// (an int64 cumsum and a searchsorted over R a lane).
#include "lanes.cuh"

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

constexpr int kSlotBatch = 8;

template <typename T, int G, int R>
__global__ void push_ell_fused_kernel(
    const int* __restrict__ sel, const uint8_t* __restrict__ ok,
    const int* __restrict__ row_src, const int* __restrict__ ell_dst,
    const float* __restrict__ ell_wgt, const T* __restrict__ values,
    const int* __restrict__ degrees, T* table, uint8_t* touched,
    long long rows, int width, long long V, bool vec8) {
  const long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (c >= rows || !ok[c]) return;
  const long long r = __ldg(sel + c);
  const int s = __ldg(row_src + r);
  const T v = __ldg(values + s);
  const int d = G == kDivDeg ? __ldg(degrees + s) : 0;
  constexpr bool kWeighted = G == kAddW || G == kMulW;
  const int* ids = ell_dst + r * width;
  const float* wts = ell_wgt + r * width;
  for (int j0 = 0; j0 < width; j0 += kSlotBatch) {
    int u[kSlotBatch];
    float w[kSlotBatch];
    if (vec8) {                      // width 8, 16-byte aligned rows
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids));
      const int4 b = __ldg(reinterpret_cast<const int4*>(ids) + 1);
      u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
      u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
      if constexpr (kWeighted) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(wts));
        const float4 q = __ldg(reinterpret_cast<const float4*>(wts) + 1);
        w[0] = p.x; w[1] = p.y; w[2] = p.z; w[3] = p.w;
        w[4] = q.x; w[5] = q.y; w[6] = q.z; w[7] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < kSlotBatch; ++k) w[k] = 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        const bool in = j0 + k < width;
        u[k] = in ? __ldg(ids + j0 + k) : kPad;
        w[k] = (kWeighted && in) ? __ldg(wts + j0 + k) : 0.0f;
      }
    }
    // the test-before-atomic reads of min and max, all in flight
    // together; a slot whose id is not a vertex (PAD) is skipped
    T cur[kSlotBatch];
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      cur[k] = (R != kAdd && static_cast<unsigned>(u[k]) < V)
                   ? __ldcg(table + u[k])
                   : T(0);
    }
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      if (static_cast<unsigned>(u[k]) >= V) continue;
      atomic_combine<T, R>(table + u[k], gather_op<T, G>(v, w[k], d),
                           cur[k]);
      if (touched != nullptr) touched[u[k]] = 1;
    }
  }
}

template <typename T, int G, int R>
cudaError_t launch_fused(const void* sel, const void* ok, const void* row_src,
                         const void* ell_dst, const void* ell_wgt,
                         const void* values, const void* degrees, void* table,
                         void* touched, long long rows, int width,
                         long long V, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (rows == 0) return cudaSuccess;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  const bool vec8 = width == kSlotBatch &&
                    reinterpret_cast<uintptr_t>(ell_dst) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(ell_wgt) % 16 == 0;
  push_ell_fused_kernel<T, G, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(sel), static_cast<const uint8_t*>(ok),
      static_cast<const int*>(row_src), static_cast<const int*>(ell_dst),
      static_cast<const float*>(ell_wgt), static_cast<const T*>(values),
      static_cast<const int*>(degrees), static_cast<T*>(table),
      static_cast<uint8_t*>(touched), rows, width, V, vec8);
  return cudaGetLastError();
}

#define FUSED_ARGS sel, ok, row_src, ell_dst, ell_wgt, values, degrees, \
                   table, touched, rows, width, V, stream

template <typename T, int G>
cudaError_t fused_by_reduce(int reduce, const void* sel, const void* ok,
                            const void* row_src, const void* ell_dst,
                            const void* ell_wgt, const void* values,
                            const void* degrees, void* table, void* touched,
                            long long rows, int width, long long V,
                            cudaStream_t stream) {
  switch (reduce) {
    case kMin: return launch_fused<T, G, kMin>(FUSED_ARGS);
    case kMax: return launch_fused<T, G, kMax>(FUSED_ARGS);
    case kAdd:
      // a push reduce only on integers: a float sum depends on the order
      if constexpr (std::is_floating_point<T>::value) {
        return cudaErrorInvalidValue;
      } else {
        return launch_fused<T, G, kAdd>(FUSED_ARGS);
      }
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t fused_by_gather(int gather, int reduce, const void* sel,
                            const void* ok, const void* row_src,
                            const void* ell_dst, const void* ell_wgt,
                            const void* values, const void* degrees,
                            void* table, void* touched, long long rows,
                            int width, long long V, cudaStream_t stream) {
  switch (gather) {
    case kCopy: return fused_by_reduce<T, kCopy>(reduce, FUSED_ARGS);
    case kPlusOne: return fused_by_reduce<T, kPlusOne>(reduce, FUSED_ARGS);
    case kAddW: return fused_by_reduce<T, kAddW>(reduce, FUSED_ARGS);
    case kMulW: return fused_by_reduce<T, kMulW>(reduce, FUSED_ARGS);
    case kDivDeg:
      // a true division: defined for float values only
      if constexpr (std::is_floating_point<T>::value) {
        return fused_by_reduce<T, kDivDeg>(reduce, FUSED_ARGS);
      } else {
        return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

#undef FUSED_ARGS

template <typename T, int G, int R, int K>
__global__ void push_ell_lanes_kernel(
    const int* __restrict__ row_src, const int* __restrict__ ell_dst,
    const float* __restrict__ ell_wgt, const T* __restrict__ values,
    const int* __restrict__ degrees, const unsigned* __restrict__ bits,
    LaneMap map, T* table, uint8_t* got, long long rows, int width,
    long long V, bool vec8) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const int s = __ldg(row_src + r);
  const unsigned live = lane_bits<K>(bits, s, l2_policy_evict_last());
  if (live == 0u) return;
  const int d = G == kDivDeg ? __ldg(degrees + s) : 0;
  constexpr bool kWeighted = G == kAddW || G == kMulW;
  const int* ids = ell_dst + r * width;
  const float* wts = ell_wgt + r * width;
  for (int j0 = 0; j0 < width; j0 += kSlotBatch) {
    int u[kSlotBatch];
    float w[kSlotBatch];
    if (vec8) {                      // width 8, 16-byte aligned rows
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids));
      const int4 b = __ldg(reinterpret_cast<const int4*>(ids) + 1);
      u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
      u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
      if constexpr (kWeighted) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(wts));
        const float4 q = __ldg(reinterpret_cast<const float4*>(wts) + 1);
        w[0] = p.x; w[1] = p.y; w[2] = p.z; w[3] = p.w;
        w[4] = q.x; w[5] = q.y; w[6] = q.z; w[7] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < kSlotBatch; ++i) w[i] = 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i) {
        const bool in = j0 + i < width;
        u[i] = in ? __ldg(ids + j0 + i) : kPad;
        w[i] = (kWeighted && in) ? __ldg(wts + j0 + i) : 0.0f;
      }
    }
    // each live lane in turn: its source value, then the slots' test
    // reads in flight together before their atomics
#pragma unroll 1
    for (unsigned left = live; left != 0u; left &= left - 1u) {
      const long long base =
          static_cast<long long>(map.row[__ffs(left) - 1]) * V;
      const T v = __ldg(values + base + s);
      T* lane_table = table + base;
      uint8_t* lane_got = got == nullptr ? nullptr : got + base;
      T cur[kSlotBatch];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i) {
        cur[i] = (R != kAdd && static_cast<unsigned>(u[i]) < V)
                     ? __ldcg(lane_table + u[i])
                     : T(0);
      }
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i) {
        if (static_cast<unsigned>(u[i]) >= V) continue;
        atomic_combine<T, R>(lane_table + u[i], gather_op<T, G>(v, w[i], d),
                             cur[i]);
        if (lane_got != nullptr) lane_got[u[i]] = 1;
      }
    }
  }
}

struct PushLaneArgs {
  const void* row_src;
  const void* ell_dst;
  const void* ell_wgt;
  const void* values;       // (k', V) lane-major state
  const void* degrees;
  const void* active;       // (k', V) bool
  LaneMap map;
  int k;
  void* bits;               // ceil(V K / 32) words of scratch
  void* table;              // (k', V), the identity in the mapped rows
  void* got;                // (k', V) bytes, or null
  long long rows;
  int width;
  long long V;
  int stage;                // Stage (lanes.cuh)
  cudaStream_t stream;
};

template <typename T, int G, int R, int K>
cudaError_t launch_push_lanes(const PushLaneArgs& a) {
  constexpr int kThreads = 256;
  if (a.stage == kPackOnly) {
    return launch_lanes_pack<int, kCopy, K, false>(
        nullptr, nullptr, static_cast<const uint8_t*>(a.active), a.map,
        static_cast<unsigned*>(a.bits), nullptr, a.V, a.k, true, a.stream);
  }
  if (a.rows == 0) return cudaSuccess;
  const bool vec8 = a.width == kSlotBatch &&
                    reinterpret_cast<uintptr_t>(a.ell_dst) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.ell_wgt) % 16 == 0;
  const long long blocks = (a.rows + kThreads - 1) / kThreads;
  push_ell_lanes_kernel<T, G, R, K><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const int*>(a.row_src), static_cast<const int*>(a.ell_dst),
      static_cast<const float*>(a.ell_wgt), static_cast<const T*>(a.values),
      static_cast<const int*>(a.degrees),
      static_cast<const unsigned*>(a.bits), a.map, static_cast<T*>(a.table),
      static_cast<uint8_t*>(a.got), a.rows, a.width, a.V, vec8);
  return cudaGetLastError();
}

template <typename T, int G, int R>
cudaError_t push_lanes_by_k(const PushLaneArgs& a, int K) {
  switch (K) {
    case 1: return launch_push_lanes<T, G, R, 1>(a);
    case 4: return launch_push_lanes<T, G, R, 4>(a);
    case 8: return launch_push_lanes<T, G, R, 8>(a);
    case 32: return launch_push_lanes<T, G, R, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G>
cudaError_t push_lanes_by_reduce(const PushLaneArgs& a, int reduce, int K) {
  switch (reduce) {
    case kMin: return push_lanes_by_k<T, G, kMin>(a, K);
    case kMax: return push_lanes_by_k<T, G, kMax>(a, K);
    case kAdd:
      // a push reduce only on integers: a float sum depends on the order
      if constexpr (std::is_floating_point<T>::value) {
        return cudaErrorInvalidValue;
      } else {
        return push_lanes_by_k<T, G, kAdd>(a, K);
      }
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t push_lanes_by_gather(const PushLaneArgs& a, int gather,
                                 int reduce, int K) {
  switch (gather) {
    case kCopy: return push_lanes_by_reduce<T, kCopy>(a, reduce, K);
    case kPlusOne: return push_lanes_by_reduce<T, kPlusOne>(a, reduce, K);
    case kAddW: return push_lanes_by_reduce<T, kAddW>(a, reduce, K);
    case kMulW: return push_lanes_by_reduce<T, kMulW>(a, reduce, K);
    case kDivDeg:
      if constexpr (std::is_floating_point<T>::value) {
        return push_lanes_by_reduce<T, kDivDeg>(a, reduce, K);
      } else {
        return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
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

// C entry point of the fused kernel.  sel (rows,) int32 and ok (rows,)
// bool are the compaction's output; ell_dst (R, width) int32, ell_wgt
// (R, width) float32 and row_src (R,) int32 the forward ELL; table (V,)
// holds the reduce identity on entry; touched (V,) bool is zero on entry,
// or null.  Returns the cudaError_t of the launch (0 = success).
extern "C" int push_ell_fused_launch(int device, int gather, int reduce,
                                     int value_is_float, const void* sel,
                                     const void* ok, const void* row_src,
                                     const void* ell_dst,
                                     const void* ell_wgt, const void* values,
                                     const void* degrees, void* table,
                                     void* touched, long long rows,
                                     int width, long long V, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_is_float
             ? fused_by_gather<float>(gather, reduce, sel, ok, row_src,
                                      ell_dst, ell_wgt, values, degrees,
                                      table, touched, rows, width, V, s)
             : fused_by_gather<int>(gather, reduce, sel, ok, row_src,
                                    ell_dst, ell_wgt, values, degrees, table,
                                    touched, rows, width, V, s);
}

// C entry point of 3L.  values and active are a (lane_rows, V) lane-major
// state; the launch pushes the k rows listed in `lanes` (host memory, k
// ints in [0, lane_rows), 1 <= k <= K <= 32, K 1, 4, 8 or 32; copied into
// the launch's parameters) over the forward ELL's `rows` rows (row_src
// (rows,) int32, ell_dst (rows, width) int32, ell_wgt (rows, width)
// float32).  `bits` (ceil(V K / 32) words) is the pre-pass's scratch;
// `table` (lane_rows, V) holds the reduce identity in the listed rows on
// entry (or running partials: the atomics combine into it either way);
// `got` (lane_rows, V) bytes, or null, takes a 1 for each (lane, vertex)
// a live message reached.  `stage` (lanes.cuh's Stage) launches the
// pre-pass, or the kernel on the bits a pre-pass call wrote.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int push_ell_lanes_launch(int device, int gather, int reduce,
                                     int value_is_float, int K,
                                     const void* row_src, const void* ell_dst,
                                     const void* ell_wgt, const void* values,
                                     const void* degrees, const void* active,
                                     const int* lanes, int k,
                                     long long lane_rows, void* bits,
                                     void* table, void* got, long long rows,
                                     int width, long long V, int stage,
                                     void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (!make_lane_map(lanes, k, K, lane_rows, &map) || !valid_stage(stage)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const PushLaneArgs a{row_src, ell_dst, ell_wgt, values, degrees, active,
                       map, k, bits, table, got, rows, width, V, stage,
                       static_cast<cudaStream_t>(stream)};
  return value_is_float ? push_lanes_by_gather<float>(a, gather, reduce, K)
                        : push_lanes_by_gather<int>(a, gather, reduce, K);
}
