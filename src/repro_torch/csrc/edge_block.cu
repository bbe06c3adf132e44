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
// int32 ids once (and W float32 weights for the weighted gathers) from
// HBM, and each live slot makes a random read of the vertex side.  On the
// main path the view is the flat width-8 pull view (W = 8, about 1.45
// slots per edge: 12.6 M rows, ~400 MB of ids at Graph500 scale 22).  The
// vertex tables fit in the 50 MB L2, so the random reads hit L2, but an
// L2 access moves a whole 32-byte sector for 1 or 4 useful bytes: every
// non-PAD slot, live or dead, pays a sector for its frontier flag, and a
// live one a second for its value, the second waiting on the first; and
// the id stream passing through the same L2 evicts the tables.  On the
// BFS most frontiers are narrow, so the dead slots' flag reads dominate.
//
// Design (a live slot costs one bit and one message read, many loads in
// flight):
// - A pre-pass of V threads, once a call, into scratch the wrapper
//   allocates, builds (a) under mask_inactive, the frontier as a bitmap,
//   1 bit a vertex (512 KB at scale 22, which stays in L1 and L2), and
//   (b) for plus_one and div_deg, the gather's message per vertex, with
//   the same _rn arithmetic, so each slot's message is bit-identical
//   (copy, add_w and mul_w read the values themselves; the main kernel
//   applies a slot's weight).  A call that needs neither launches none.
// - The main kernel runs one thread per row.  At W = 8, the width every
//   caller passes, a row's ids come as two 16-byte loads that skip L1 and
//   are marked evict-first in L2; its 8 frontier bits are read together,
//   then its live slots' messages together, with an L2 evict-last policy
//   so that the id stream does not push them out.  A dead slot of a
//   narrow frontier costs one read of the small bitmap, where a byte
//   table (4 MB) or a packed (message, live) table of 8-byte entries
//   (33.5 MB) cost a random L2 sector.  Other widths take a loop over the
//   slots with the same tables.  Slots are reduced in slot order, dead
//   slots as the identity, so a float add sums lanes 0..W-1 in order, as
//   before; the TPU version's VMEM tiling (block_rows) has no counterpart.
//
// The block-skipping variant (kSkip) replaces the Pallas kernel
// repro/kernels/edge_block.py::_kernel_skip, dispatched when
// edge_block_reduce gets block_live=: rows come in blocks of block_rows,
// and a row whose block_live[r / block_rows] flag is 0 writes the reduce
// identity and any = 0 and returns before reading an id or a table.
// It is bound by bytes too, but only the live blocks' id streams count:
// the ids of live blocks, the vertex tables, the (R / block_rows) flags
// and the two outputs over all R rows.  With block_rows >= 32 (the bitmap
// plane uses 128) a warp reads one flag, so a dead block costs one byte
// and two stores per row and nothing diverges; live rows run kernel 1's
// body.  The same pre-pass serves both variants.
#include "lanes.cuh"

namespace repro_torch {
namespace {

// The pre-pass: frontier bits (with kMask) and messages (with kMsg) of
// vertices [32 w, 32 w + 32) in warp w.
template <typename T, int G, bool kMask, bool kMsg>
__global__ void edge_block_pack_kernel(const T* __restrict__ values,
                                       const int* __restrict__ degrees,
                                       const uint8_t* __restrict__ active,
                                       unsigned* __restrict__ bits,
                                       T* __restrict__ msg, long long V) {
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if constexpr (kMask) {
    const unsigned word = __ballot_sync(~0u, u < V && active[u] != 0);
    if ((threadIdx.x & 31) == 0 && u < V) bits[u >> 5] = word;
  }
  if constexpr (kMsg) {
    if (u < V) {
      msg[u] = gather_op<T, G>(values[u], 0.0f,
                               G == kDivDeg ? degrees[u] : 0);
    }
  }
}

template <typename T, int G, int R, bool kMask, bool kSkip, bool kW8>
__global__ void edge_block_kernel(const uint8_t* __restrict__ block_live,
                                  long long block_rows,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ wgt,
                                  const unsigned* __restrict__ bits,
                                  const T* __restrict__ msg,
                                  T* __restrict__ out,
                                  uint8_t* __restrict__ any_out,
                                  long long rows, int width) {
  constexpr bool kW = weighted(G);
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const T ident = reduce_identity<T, R>();
  if (kSkip && __ldg(block_live + r / block_rows) == 0) {
    out[r] = ident;
    any_out[r] = 0;
    return;
  }
  T acc = ident;
  bool any = false;
  if constexpr (kW8) {
    const uint64_t first = l2_policy_evict_first();
    const uint64_t last = l2_policy_evict_last();
    const int4 lo = load_stream(nbr + r * 8, first);
    const int4 hi = load_stream(nbr + r * 8 + 4, first);
    const int ids[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    bool live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {        // the row's 8 bits in flight
      live[j] = ids[j] != kPad;
      if (kMask && live[j]) {
        live[j] = (load_table(bits + (ids[j] >> 5), last) >> (ids[j] & 31)) &
                  1u;
      }
    }
    unsigned m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {        // then its live messages
      m[j] = live[j] ? load_table(msg + ids[j], last) : 0u;
    }
    float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (kW) {
      const int4 wl = load_stream(wgt + r * 8, first);
      const int4 wh = load_stream(wgt + r * 8 + 4, first);
      const int wb[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = __int_as_float(wb[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T x = ident;
      if (live[j]) {
        x = from_bits<T>(m[j]);
        if constexpr (kW) x = gather_op<T, G>(x, w[j], 0);
      }
      acc = combine<T, R>(acc, x);
      any |= live[j];
    }
  } else {
    const int* row = nbr + r * width;
    const float* wrow = wgt + r * width;
    for (int j = 0; j < width; ++j) {
      const int u = __ldg(row + j);
      bool live = u != kPad;
      if (kMask && live) live = (__ldg(bits + (u >> 5)) >> (u & 31)) & 1u;
      T x = ident;
      if (live) {
        x = __ldg(msg + u);
        if constexpr (kW) x = gather_op<T, G>(x, __ldg(wrow + j), 0);
        any = true;
      }
      acc = combine<T, R>(acc, x);
    }
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
  void* bits;               // ceil(V / 32) words of scratch (mask_inactive)
  void* msg;                // (V,) scratch for plus_one and div_deg
  long long V;
  void* out;
  void* any;
  long long rows;
  int width;
  int stage;                // Stage
  cudaStream_t stream;
};

template <typename T, int G, int R, bool kMask, bool kSkip, bool kW8>
cudaError_t launch_main(const Args& a, const T* msg) {
  constexpr int kThreads = 256;
  const long long blocks = (a.rows + kThreads - 1) / kThreads;
  edge_block_kernel<T, G, R, kMask, kSkip, kW8>
      <<<blocks, kThreads, 0, a.stream>>>(
          static_cast<const uint8_t*>(a.block_live), a.block_rows,
          static_cast<const int*>(a.nbr), static_cast<const float*>(a.wgt),
          static_cast<const unsigned*>(a.bits), msg, static_cast<T*>(a.out),
          static_cast<uint8_t*>(a.any), a.rows, a.width);
  return cudaGetLastError();
}

template <typename T, int G, int R, bool kMask>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = 256;
  constexpr bool kMsg = needs_msg(G);
  if (a.stage == kPackOnly) {
    if (!(kMask || kMsg) || a.V == 0) return cudaSuccess;
    const long long blocks = (a.V + kThreads - 1) / kThreads;
    edge_block_pack_kernel<T, G, kMask, kMsg>
        <<<blocks, kThreads, 0, a.stream>>>(
            static_cast<const T*>(a.values),
            static_cast<const int*>(a.degrees),
            static_cast<const uint8_t*>(a.active),
            static_cast<unsigned*>(a.bits), static_cast<T*>(a.msg), a.V);
    return cudaGetLastError();
  }
  const T* msg = static_cast<const T*>(kMsg ? a.msg : a.values);
  // the width-8 path loads rows as 16-byte vectors
  const bool w8 = a.width == 8 &&
                  reinterpret_cast<uintptr_t>(a.nbr) % 16 == 0 &&
                  (!weighted(G) ||
                   reinterpret_cast<uintptr_t>(a.wgt) % 16 == 0);
  if (a.block_live) {
    return w8 ? launch_main<T, G, R, kMask, true, true>(a, msg)
              : launch_main<T, G, R, kMask, true, false>(a, msg);
  }
  return w8 ? launch_main<T, G, R, kMask, false, true>(a, msg)
            : launch_main<T, G, R, kMask, false, false>(a, msg);
}

template <typename T, int G, int R>
cudaError_t by_mask(const Args& a, int mask) {
  return mask ? launch<T, G, R, true>(a) : launch<T, G, R, false>(a);
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

// ---------------------------------------------------------------------------
// The lane-axis variants: kernel 1 over k lanes at once (k frontiers and
// value tables over one graph, as the vmapped Pallas kernel runs under the
// JAX package's batched runs).  K is k rounded up to 1, 4, 8 or 32 (the
// wrappers split wider batches into launches of 32 lanes); mask_inactive
// is a launch argument, not a template one, to keep the build short.  A
// launch reads its k lanes from rows of a (k', V) state through a lane
// map (lanes.cuh), in place.
//
// Pre-pass (lanes.cuh, lanes_pack_kernel), one thread a vertex u: the K
// lanes' messages of u in one vertex-major row msg[u * K .. u * K + K),
// and under mask_inactive u's K frontier bits.
//
// Per sub-row r, one thread (lanes_row): the row's ids are read once, as
// kernel 1 reads them; per slot one read of the vertex's K frontier bits
// and, when any lane is live there, one read of its K messages; each lane
// reduces the row's slots in slot order with the dead slots as the
// identity, exactly as kernel 1 reduces one lane.
//
// edge_block_lanes_kernel, the first lane-axis design: writes the (k, rows)
// sub-row partials and any-live flags, lane-major (row l of each for the
// launch's lane l); the caller folds them into vertices (subrow_combine).  The translator keeps it for float add,
// where a lane's fold must sum sub-rows in the order a sequential run's
// torch reductions do (bit-equal served answers), and an atomic fold would
// not.
//
// edge_block_fold_kernel, the redesign: the lane sweep with the sub-row
// fold fused in, for the order-free reduces (min, max, int32 add).  It goes
// from the flat (rows, 8) view and owner8 straight to (k', V) reduced and
// got tables, at the lanes' own rows; no (k, rows) array is written.  A
// vertex's sub-rows are consecutive in the flat view (split hubs' included,
// so owner8 names their vertex and no separate scatter is needed), so after
// lanes_row the warp runs a segmented reduce over its runs of equal owners:
// a suffix scan by shuffles, log2 of the warp's longest run steps, each
// lane's partial and any-bits.  The first thread of each run then holds the
// run's combine.  A run that is a whole segment (it starts and ends inside
// the warp, or its neighbours in the view have other owners) stores each
// lane's value with a plain store; a piece of a segment that crosses a warp
// or block edge combines into the identity-filled table with an atomic
// after a plain test read (gather_ops.cuh, atomic_combine: int32
// atomicMin/Max/Add, float min/max a compare-and-swap loop that propagates
// NaN).  Every combine, in a thread, in the warp's scan and in the atomics,
// settles a +0/-0 tie the same way (a min keeps -0, a max +0), so the
// table's bits do not depend on the order the pieces land in; the plain
// version settles ties so too (ref.settle_zero_ties).  A lane whose combine is the
// identity writes nothing; the got table (zero-filled bytes) takes a plain
// store of 1 for each lane with a live slot, since a message can equal the
// identity.  Pad sub-rows (owner V) and threads past the view write nothing.
//
// Accumulate mode (the streamed engine's pull partitions, the counterpart
// of the per-partition jax.ops.segment_* and the partials' combine in
// repro/core/stream.py): the tables hold the earlier partitions' partials
// on entry, so a whole run's plain store becomes a read-combine-store
// (one thread owns the entry in the launch, so it needs no atomic), the
// pieces' atomics combine as before, and got takes its stores of 1, an
// OR.  An owner's rows lie in several partitions, and each partition's
// launch folds its own runs into the running table.
//
// What bounds the fold kernel on an H100: bytes.  It must read the ids once
// (R8 x 32 B, 0.40 GB at scale 22), owner8 (R8 x 4 B), each lane's values
// and frontier (k x V x 5 B) and write each lane's (V,) table and flags (k
// x V x 5 B): 0.79 GB, 0.24 ms, at k = 8.  Beyond that it pays the
// pre-pass's vertex-major table (k x V x 4 B written, then read a 32-byte
// row a live slot: 134 MB at k = 8, past the 50 MB L2) and the table's
// fill.
// ---------------------------------------------------------------------------

template <typename T, int GW, int R, int K>
__global__ void edge_block_lanes_kernel(const int* __restrict__ nbr,
                                        const float* __restrict__ wgt,
                                        const unsigned* __restrict__ bits,
                                        const T* __restrict__ msg,
                                        T* __restrict__ out,
                                        uint8_t* __restrict__ any_out,
                                        long long rows, int width, int k,
                                        bool mask, bool w8) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  T acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = reduce_identity<T, R>();
  unsigned any = 0;
  lanes_row<T, GW, R, K>(nbr, wgt, bits, msg, r, width, mask, w8, acc, any);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < k) {
      out[l * rows + r] = acc[l];
      if (any_out != nullptr) any_out[l * rows + r] = (any >> l) & 1u;
    }
  }
}

template <typename T, int GW, int R, int K>
__global__ void __launch_bounds__(256) edge_block_fold_kernel(
    const int* __restrict__ nbr, const float* __restrict__ wgt,
    const int* __restrict__ owner8, const unsigned* __restrict__ bits,
    const T* __restrict__ msg, LaneMap map, T* red, uint8_t* got,
    long long rows, long long V, int width, int k, bool mask, bool w8,
    bool accumulate) {
  const T ident = reduce_identity<T, R>();
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const int t = threadIdx.x & 31;
  T acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = ident;
  unsigned any = 0;
  int o = -1;                            // past the view: no owner
  if (r < rows) {
    o = __ldg(owner8 + r);
    lanes_row<T, GW, R, K>(nbr, wgt, bits, msg, r, width, mask, w8, acc,
                           any);
  }
  // bit t of `same`: threads t and t + 1 hold sub-rows of one owner
  const int o_next = __shfl_down_sync(~0u, o, 1);
  const unsigned same = __ballot_sync(~0u, t < 31 && o_next == o);
  int span = 1;                          // the warp's longest run
  for (unsigned x = same; x != 0u; x &= x >> 1) ++span;
  for (int off = 1; off < span; off <<= 1) {
    const int o2 = __shfl_down_sync(~0u, o, off);
    const bool take = t + off < 32 && o2 == o;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const T x = __shfl_down_sync(~0u, acc[l], off);
      if (take) acc[l] = combine<T, R>(acc[l], x);
    }
    const unsigned a2 = __shfl_down_sync(~0u, any, off);
    if (take) any |= a2;
  }
  const int o_prev = __shfl_up_sync(~0u, o, 1);
  if (o < 0 || o >= V || (t > 0 && o_prev == o)) return;
  // this thread heads the warp's run t .. t + n of owner o
  const int n = __ffs(~(same >> t)) - 1;
  const bool starts = t > 0 || r == 0 || __ldg(owner8 + r - 1) != o;
  const long long end = r + n;
  const bool ends = t + n < 31 || end + 1 >= rows ||
                    __ldg(owner8 + end + 1) != o;
  const bool whole = starts && ends;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < k) {
      const long long at = map.row[l] * V + o;
      if (got != nullptr && ((any >> l) & 1u)) got[at] = 1;
      if (acc[l] != ident) {
        if (whole) {
          red[at] = accumulate ? combine<T, R>(red[at], acc[l]) : acc[l];
        } else {
          atomic_combine<T, R>(red + at, acc[l],
                               R == kAdd ? T(0) : __ldcg(red + at));
        }
      }
    }
  }
}

// What both lane kernels read: the graph, the (k', V) state through the
// lane map, and the pre-pass's scratch.
struct LaneArgs {
  bool mask;                // mask_inactive
  const void* nbr;
  const void* wgt;
  const void* values;       // (k', V) lane-major state
  const void* degrees;
  const void* active;       // (k', V) bool
  LaneMap map;              // the launch's k lanes: rows of the state
  void* bits;               // ceil(V K / 32) words (mask_inactive)
  void* msg;                // (V, K) vertex-major messages
  long long V;
  int k;
  long long rows;
  int width;
  int stage;                // Stage
  cudaStream_t stream;
};

// The first design's outputs: (k, rows) sub-row partials and any-live
// bytes (or null), row l for the launch's lane l.
struct SubRowOut {
  void* out;
  void* any;
};

// The fold's: owner vertices of the view's rows, and the (k', V) reduced
// table (the identity in the listed rows) and got bytes (0 there, or null).
struct FoldOut {
  const void* owner8;
  void* red;
  void* got;
  bool accumulate;          // combine into the tables' partials
};

template <typename T, int G, int R, int K, typename Out>
cudaError_t launch_lanes(const LaneArgs& a, const Out& o) {
  constexpr int kThreads = 256;
  constexpr int GW = weighted(G) ? G : kCopy;   // the main kernel's gather
  if constexpr (std::is_same<Out, FoldOut>::value &&
                std::is_floating_point<T>::value && R == kAdd) {
    return cudaErrorInvalidValue;      // a float sum's fold has an order
  } else {
    if (a.stage == kPackOnly) {
      return launch_lanes_pack<T, G, K, true>(
          static_cast<const T*>(a.values),
          static_cast<const int*>(a.degrees),
          static_cast<const uint8_t*>(a.active), a.map,
          static_cast<unsigned*>(a.bits), static_cast<T*>(a.msg), a.V, a.k,
          a.mask, a.stream);
    }
    if (a.rows == 0) return cudaSuccess;
    const bool w8 = a.width == 8 &&
                    reinterpret_cast<uintptr_t>(a.nbr) % 16 == 0 &&
                    (!weighted(G) ||
                     reinterpret_cast<uintptr_t>(a.wgt) % 16 == 0);
    const long long blocks = (a.rows + kThreads - 1) / kThreads;
    const int* nbr = static_cast<const int*>(a.nbr);
    const float* wgt = static_cast<const float*>(a.wgt);
    const unsigned* bits = static_cast<const unsigned*>(a.bits);
    const T* msg = static_cast<const T*>(a.msg);
    if constexpr (std::is_same<Out, SubRowOut>::value) {
      edge_block_lanes_kernel<T, GW, R, K>
          <<<blocks, kThreads, 0, a.stream>>>(
              nbr, wgt, bits, msg, static_cast<T*>(o.out),
              static_cast<uint8_t*>(o.any), a.rows, a.width, a.k, a.mask,
              w8);
    } else {
      edge_block_fold_kernel<T, GW, R, K>
          <<<blocks, kThreads, 0, a.stream>>>(
              nbr, wgt, static_cast<const int*>(o.owner8), bits, msg, a.map,
              static_cast<T*>(o.red), static_cast<uint8_t*>(o.got), a.rows,
              a.V, a.width, a.k, a.mask, w8, o.accumulate);
    }
    return cudaGetLastError();
  }
}

template <typename T, int G, int R, typename Out>
cudaError_t lanes_by_k(const LaneArgs& a, const Out& o, int K) {
  switch (K) {
    case 1: return launch_lanes<T, G, R, 1>(a, o);
    case 4: return launch_lanes<T, G, R, 4>(a, o);
    case 8: return launch_lanes<T, G, R, 8>(a, o);
    case 32: return launch_lanes<T, G, R, 32>(a, o);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G, typename Out>
cudaError_t lanes_by_reduce(const LaneArgs& a, const Out& o, int reduce,
                            int K) {
  switch (reduce) {
    case kAdd: return lanes_by_k<T, G, kAdd>(a, o, K);
    case kMin: return lanes_by_k<T, G, kMin>(a, o, K);
    case kMax: return lanes_by_k<T, G, kMax>(a, o, K);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename Out>
cudaError_t lanes_by_gather(const LaneArgs& a, const Out& o, int gather,
                            int reduce, int K) {
  switch (gather) {
    case kCopy: return lanes_by_reduce<T, kCopy>(a, o, reduce, K);
    case kPlusOne: return lanes_by_reduce<T, kPlusOne>(a, o, reduce, K);
    case kAddW: return lanes_by_reduce<T, kAddW>(a, o, reduce, K);
    case kMulW: return lanes_by_reduce<T, kMulW>(a, o, reduce, K);
    case kDivDeg:
      if constexpr (std::is_floating_point<T>::value) {
        return lanes_by_reduce<T, kDivDeg>(a, o, reduce, K);
      } else {
        return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  value_is_float selects float32 (1) or
// int32 (0) values; a null block_live launches kernel 1, a non-null one
// the block-skipping variant over blocks of block_rows rows.  `bits`
// (ceil(V / 32) int32 words, with mask_inactive) and `msg` ((V,) of the
// value type, for plus_one and div_deg) are scratch for the pre-pass, null
// where unused.  `stage` (Stage) launches the pre-pass, or the main kernel
// on the tables a pre-pass call wrote.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int edge_block_reduce_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    const void* block_live, long long block_rows, const void* nbr,
    const void* wgt, const void* values, const void* degrees,
    const void* active, void* bits, void* msg, long long V, void* out,
    void* any,
    long long rows, int width, int stage, void* stream) {
  using namespace repro_torch;
  if (block_live != nullptr && block_rows < 1) return cudaErrorInvalidValue;
  if (!valid_stage(stage)) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  const Args a{block_live, block_rows, nbr, wgt, values, degrees, active,
               bits, msg, V, out, any, rows, width, stage,
               static_cast<cudaStream_t>(stream)};
  return value_is_float ? by_gather<float>(a, gather, reduce, mask_inactive)
                        : by_gather<int>(a, gather, reduce, mask_inactive);
}

// C entry point of the lanes kernel.  values and active are a (lane_rows,
// V) lane-major state; the launch sweeps the k rows listed in `lanes` (host
// memory, k ints in [0, lane_rows), 1 <= k <= K; copied into the launch's
// parameters), K is 1, 4, 8 or 32.  `bits` (ceil(V K / 32) words, with
// mask_inactive) and `msg` ((V, K) of the value type) are scratch for the
// pre-pass; `out` is (k, rows) of the value type and `any` (k, rows)
// bytes, or null when the caller needs no flags, row l for lanes[l].
// `stage` as edge_block_reduce_launch's.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int edge_block_lanes_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    int K, const void* nbr, const void* wgt, const void* values,
    const void* degrees, const void* active, const int* lanes, int k,
    long long lane_rows, void* bits, void* msg, long long V, void* out,
    void* any, long long rows, int width, int stage, void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (!make_lane_map(lanes, k, K, lane_rows, &map) || !valid_stage(stage)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const LaneArgs a{mask_inactive != 0, nbr, wgt, values, degrees, active,
                   map, bits, msg, V, k, rows, width, stage,
                   static_cast<cudaStream_t>(stream)};
  const SubRowOut o{out, any};
  return value_is_float ? lanes_by_gather<float>(a, o, gather, reduce, K)
                        : lanes_by_gather<int>(a, o, gather, reduce, K);
}

// C entry point of the fold kernel, for min, max and int32 add: the lanes
// kernel's inputs, and owner8, the flat view's (rows,) owner vertices (V
// for pad sub-rows).  `red` is (lane_rows, V) of the value type holding
// the reduce identity in the listed rows on entry, `got` (lane_rows, V)
// bytes holding 0 there, or null; with `accumulate` they hold running
// partials instead, which the launch combines into.  `stage` as
// edge_block_reduce_launch's.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int edge_block_fold_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    int K, const void* nbr, const void* wgt, const void* owner8,
    const void* values, const void* degrees, const void* active,
    const int* lanes, int k, long long lane_rows, void* bits, void* msg,
    long long V, void* red, void* got, long long rows, int width,
    int accumulate, int stage, void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (owner8 == nullptr || !make_lane_map(lanes, k, K, lane_rows, &map) ||
      !valid_stage(stage)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const LaneArgs a{mask_inactive != 0, nbr, wgt, values, degrees, active,
                   map, bits, msg, V, k, rows, width, stage,
                   static_cast<cudaStream_t>(stream)};
  const FoldOut o{owner8, red, got, accumulate != 0};
  return value_is_float ? lanes_by_gather<float>(a, o, gather, reduce, K)
                        : lanes_by_gather<int>(a, o, gather, reduce, K);
}
