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
// 2L, the lane sweep with a per-lane early-out (the counterpart of
// repro/kernels/edge_block.py::_kernel_skip under jax.vmap, which the JAX
// package's batched runs reach on the bitmap plane: each lane's block flags
// batched into one launch of the early-out kernel).  A launch's flags are
// one word a grid block of block_rows sub-rows, bit l for its lane l,
// built on the card from the lanes' touched tables (lanes_vertex_words_
// kernel, then lanes_block_words_kernel, below).  The sub-row kernel
// (edge_block_lanes_kernel, float add) ANDs its row's word into each slot's
// frontier bits (lanes_row's `on`), since its order belongs to
// subrow_combine.  The fold of the order-free reduces takes a
// kernel of its own, edge_block_skip_fold_kernel, described at it.  On the
// bitmap plane the flags come from each lane's touched table, and a dead
// block's owners have no active in-neighbour in that lane, so 2L on those
// flags equals 1L bit for bit; on any flags it equals k single-lane
// kernel-2 sweeps (and, in the fold, their sub-row fold).  Bound: as 1L's,
// but only the rows of a block live in some lane count, plus the flags.
//
// What bounds the fold kernel on an H100: bytes.  It must read the ids once
// (R8 x 32 B, 0.40 GB at scale 22), owner8 (R8 x 4 B), each lane's values
// and frontier (k x V x 5 B) and write each lane's (V,) table and flags (k
// x V x 5 B): 0.79 GB, 0.24 ms, at k = 8.  Beyond that it pays the
// pre-pass's vertex-major table (k x V x 4 B written, then read a 32-byte
// row a live slot: 134 MB at k = 8, past the 50 MB L2) and the table's
// fill.
// ---------------------------------------------------------------------------

// The lanes whose flags let row r be read: its grid block's word, or every
// lane without flags (1L).
__device__ __forceinline__ unsigned row_lanes_on(
    const unsigned* __restrict__ words, long long block_rows, long long r) {
  return words == nullptr ? ~0u : __ldg(words + r / block_rows);
}

template <typename T, int GW, int R, int K>
__global__ void edge_block_lanes_kernel(const int* __restrict__ nbr,
                                        const float* __restrict__ wgt,
                                        const unsigned* __restrict__ bits,
                                        const T* __restrict__ msg,
                                        const unsigned* __restrict__ words,
                                        long long block_rows,
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
  const unsigned on = row_lanes_on(words, block_rows, r);
  if (on != 0u) {
    lanes_row<T, GW, R, K>(nbr, wgt, bits, msg, r, width, mask, w8, acc, any,
                           on);
  }
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

// Lane l's row of the state, read from the lane map by an unrolled select
// (no dynamic index into the launch's parameters).
__device__ __forceinline__ long long lane_row(const LaneMap& map, int l) {
  int row = 0;
#pragma unroll
  for (int i = 0; i < kMaxLanes; ++i) row = i == l ? map.row[i] : row;
  return row;
}

// 2L's fold, the Hopper redesign: flagged launches of min, max and int32
// add over the flat width-8 view, under mask_inactive.  What the first
// design (edge_block_fold_kernel with a word a row) paid, and what this one
// does about it:
// - A thread a sub-row over all ~11.9 M sub-rows at scale 22, each reading
//   owner8, its block's word and joining the warp's scan, dead or alive.
//   Here a warp owns one grid block of block_rows sub-rows and reads its
//   word first: a zero word returns at once, so a dead block costs one
//   4-byte load a warp and reads no owner8, no id, no weight, no message.
// - K accumulators and K-wide message rows a thread (128 B a live slot at
//   K = 32, 680-880 bytes of spills).  Here the warp is 32 / K row streams
//   x K lanes, a thread one (stream, lane) pair: it holds one accumulator,
//   one any-bit and its stream's current owner, nothing K wide, and loads
//   only its own lane's 4-byte message where its lane's bit is set.  The
//   live lanes of one slot read neighbouring words of the vertex-major
//   table, so they share one request.  A thread whose lane's bit of the
//   word is 0 folds nothing.
// - Loads in flight.  A step takes K consecutive rows of each stream, one a
//   thread: its 8 ids as two 16-byte loads, its owner (and weights) beside
//   them, its slots' K frontier bits (the pre-pass's words, ANDed with the
//   block's word) all at once, as kernel 1 reads a row.  K ballots tell each
//   thread which of its stream's K rows hold a live slot of its own lane;
//   the rows' ids, bits, owners and weights go through the warp's shared
//   memory, and each thread takes its live rows two at a time, their
//   messages (up to 16) in flight before it combines them in row order.
//   At K = 1 a thread reads and folds its own rows alone, two rows a step
//   with all their loads in flight.
// - Owners.  A stream's rows are consecutive (ceil(n / S) of the block's n
//   rows a stream), so it folds each run of equal owners in row order in a
//   register and flushes it when the owner changes (at its next live slot)
//   or at the end.  A run that is whole inside the stream (not the stream's
//   first owner continuing from the row before it, nor its last owner
//   continuing past it) takes a plain store, or a read-combine-store under
//   accumulate; a piece that crosses a stream, warp or grid-block edge
//   combines by atomic_combine after a plain test read.  Combines settle a
//   +0/-0 tie as combine() does (a min keeps -0, a max +0), so the bits do
//   not depend on the order.  A run whose combine is the identity writes no
//   value; got takes a plain store of 1 for a run with a live slot.
// The same bytes bound it as the first design, but only the rows of blocks
// live in some lane are read: their ids and owners (36 B a sub-row), a
// frontier word a valid slot (from L2), a message a live (slot, lane) pair.
constexpr int kFoldThreads = 256;

template <typename T, int GW, int R, int K>
__global__ void __launch_bounds__(kFoldThreads, 4) edge_block_skip_fold_kernel(
    const int* __restrict__ nbr, const float* __restrict__ wgt,
    const int* __restrict__ owner8, const unsigned* __restrict__ bits,
    const T* __restrict__ msg, const unsigned* __restrict__ words,
    long long block_rows, long long nblk, LaneMap map, T* red, uint8_t* got,
    long long rows, long long V, int k, bool accumulate) {
  constexpr int S = 32 / K;                  // row streams a warp
  constexpr int P = 2;                       // rows whose loads fly together
  constexpr int kWarps = kFoldThreads / 32;
  constexpr bool kW = weighted(GW);
  constexpr unsigned kPos = K == 32 ? ~0u : (1u << K) - 1u;
  // a warp's rows of a step: ids and bits (K > 1: read by the stream's
  // other threads), weights (weighted gathers) and owners
  __shared__ uint4 s_id[K > 1 ? kWarps : 1][32][2];
  __shared__ uint4 s_fb[K > 1 ? kWarps : 1][32][2];
  __shared__ uint4 s_w[K > 1 && kW ? kWarps : 1][32][2];
  __shared__ int s_o[K > 1 ? kWarps : 1][32];
  const long long b =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (b >= nblk) return;                     // warp-uniform
  const unsigned word =
      __ldg(words + b) & (k >= 32 ? ~0u : (1u << k) - 1u);
  if (word == 0u) return;                    // a dead block reads nothing
  const int wi = K > 1 ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int t = threadIdx.x & 31;
  const int l = t % K;
  const int s = t / K;
  const T ident = reduce_identity<T, R>();
  const uint64_t first = l2_policy_evict_first();
  const uint64_t last = l2_policy_evict_last();
  const long long r0 = b * block_rows;
  const long long n = min(block_rows, rows - r0);
  const long long per = (n + S - 1) / S;     // rows a stream
  const long long sa = r0 + min(n, s * per);  // this stream's rows [sa, sb)
  const long long sb = r0 + min(n, (s + 1) * per);
  constexpr int kRows = K == 1 ? 2 : K;      // a stream's rows a step
  const int steps = static_cast<int>((per + kRows - 1) / kRows);
  const bool on = (word >> l) & 1u;
  // the stream's first and last owners, and whether their runs go on past
  // the stream's rows (read once a live block, only by a thread that folds)
  int head = -1, tail = -1;
  bool head_shared = false, tail_shared = false;
  if (on && sa < sb) {
    head = __ldg(owner8 + sa);
    tail = __ldg(owner8 + sb - 1);
    head_shared = sa > 0 && __ldg(owner8 + sa - 1) == head;
    tail_shared = sb < rows && __ldg(owner8 + sb) == tail;
  }
  const long long base = on ? lane_row(map, l) * V : 0;
  T acc = ident;
  bool any = false;
  int cur = -1;                              // the owner acc folds
  auto flush = [&]() {
    if (any && cur >= 0 && cur < V) {
      const long long at = base + cur;
      if (got != nullptr) got[at] = 1;
      if (acc != ident) {
        const bool piece = (cur == head && head_shared) ||
                           (cur == tail && tail_shared);
        if (!piece) {
          red[at] = accumulate ? combine<T, R>(red[at], acc) : acc;
        } else {
          atomic_combine<T, R>(red + at, acc,
                               R == kAdd ? T(0) : __ldcg(red + at));
        }
      }
    }
    acc = ident;
    any = false;
  };
  for (int step = 0; step < steps; ++step) {
    if constexpr (K == 1) {
      // a stream a thread: two of its rows a step, all their loads in
      // flight (ids, owners, weights, then 16 bits, then the messages)
      const long long r = sa + 2LL * step;
      unsigned id[2][8], w[2][8], sel[2] = {0u, 0u};
      int o[2] = {-1, -1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          id[h][c] = static_cast<unsigned>(kPad);
          w[h][c] = 0u;
        }
        if (r + h < sb) {
          const int4 lo = load_stream(nbr + (r + h) * 8, first);
          const int4 hi = load_stream(nbr + (r + h) * 8 + 4, first);
          id[h][0] = lo.x; id[h][1] = lo.y; id[h][2] = lo.z;
          id[h][3] = lo.w; id[h][4] = hi.x; id[h][5] = hi.y;
          id[h][6] = hi.z; id[h][7] = hi.w;
          o[h] = __ldg(owner8 + r + h);
          if constexpr (kW) {
            const int4 wl = load_stream(wgt + (r + h) * 8, first);
            const int4 wh = load_stream(wgt + (r + h) * 8 + 4, first);
            w[h][0] = wl.x; w[h][1] = wl.y; w[h][2] = wl.z;
            w[h][3] = wl.w; w[h][4] = wh.x; w[h][5] = wh.y;
            w[h][6] = wh.z; w[h][7] = wh.w;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // the rows' bits in flight
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int u = static_cast<int>(id[h][c]);
          if (u != kPad && (lane_bits<1>(bits, u, last) & word)) {
            sel[h] |= 1u << c;
          }
        }
      }
      if ((sel[0] | sel[1]) != 0u) {
        unsigned m[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            m[h][c] = (sel[h] >> c) & 1u
                          ? load_table(msg + static_cast<int>(id[h][c]), last)
                          : 0u;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (sel[h] == 0u) continue;
          if (o[h] != cur) {                 // a row has one owner
            flush();
            cur = o[h];
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if ((sel[h] >> c) & 1u) {
              T x = from_bits<T>(m[h][c]);
              if constexpr (kW) {
                x = gather_op<T, GW>(x, __uint_as_float(w[h][c]), 0);
              }
              acc = combine<T, R>(acc, x);
              any = true;
            }
          }
        }
      }
    } else {
      // this thread's row: the stream's row step * K + l
      const long long r = sa + static_cast<long long>(step) * K + l;
      unsigned id[8], fb[8], w[8];
      int o = -1;
      unsigned live = 0u;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        id[c] = static_cast<unsigned>(kPad);
        fb[c] = 0u;
        w[c] = 0u;
      }
      if (r < sb) {
        const int4 lo = load_stream(nbr + r * 8, first);
        const int4 hi = load_stream(nbr + r * 8 + 4, first);
        id[0] = lo.x; id[1] = lo.y; id[2] = lo.z; id[3] = lo.w;
        id[4] = hi.x; id[5] = hi.y; id[6] = hi.z; id[7] = hi.w;
        o = __ldg(owner8 + r);
        if constexpr (kW) {
          const int4 wl = load_stream(wgt + r * 8, first);
          const int4 wh = load_stream(wgt + r * 8 + 4, first);
          w[0] = wl.x; w[1] = wl.y; w[2] = wl.z; w[3] = wl.w;
          w[4] = wh.x; w[5] = wh.y; w[6] = wh.z; w[7] = wh.w;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {        // the row's bits in flight
          fb[c] = static_cast<int>(id[c]) == kPad
                      ? 0u
                      : lane_bits<K>(bits, static_cast<int>(id[c]), last) &
                            word;
          live |= fb[c];
        }
      }
      // the rows of this thread's stream holding a live slot of its lane
      unsigned mine = 0u;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const unsigned bj = __ballot_sync(~0u, (live >> j) & 1u);
        if (j == l) mine = (bj >> (s * K)) & kPos;
      }
      if (__any_sync(~0u, mine != 0u)) {
        s_id[wi][t][0] = make_uint4(id[0], id[1], id[2], id[3]);
        s_id[wi][t][1] = make_uint4(id[4], id[5], id[6], id[7]);
        s_fb[wi][t][0] = make_uint4(fb[0], fb[1], fb[2], fb[3]);
        s_fb[wi][t][1] = make_uint4(fb[4], fb[5], fb[6], fb[7]);
        if constexpr (kW) {
          s_w[wi][t][0] = make_uint4(w[0], w[1], w[2], w[3]);
          s_w[wi][t][1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        s_o[wi][t] = o;
        __syncwarp();
        while (mine != 0u) {                 // P live rows at a time
          unsigned sel[P], m[P][8];          // sel: the row's live slots
          int src[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int q = __ffs(mine) - 1;   // -1: no row left
            mine &= mine - 1u;
            src[p] = s * K + (q < 0 ? 0 : q);
            const uint4 f0 = s_fb[wi][src[p]][0], f1 = s_fb[wi][src[p]][1];
            const unsigned f[8] = {f0.x, f0.y, f0.z, f0.w,
                                   f1.x, f1.y, f1.z, f1.w};
            sel[p] = 0u;
#pragma unroll
            for (int c = 0; c < 8; ++c) sel[p] |= ((f[c] >> l) & 1u) << c;
            if (q < 0) sel[p] = 0u;
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {      // this lane's messages in flight
            const unsigned* ids =
                reinterpret_cast<const unsigned*>(s_id[wi][src[p]]);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              m[p][c] = (sel[p] >> c) & 1u
                            ? load_table(msg + static_cast<long long>(
                                                   static_cast<int>(ids[c])) *
                                                   K + l,
                                         last)
                            : 0u;
            }
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {      // then combined in row order
            if (sel[p] == 0u) continue;
            const int o_p = s_o[wi][src[p]];
            if (o_p != cur) {                // a row has one owner
              flush();
              cur = o_p;
            }
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if ((sel[p] >> c) & 1u) {
                T x = from_bits<T>(m[p][c]);
                if constexpr (kW) {
                  const unsigned* wts =
                      reinterpret_cast<const unsigned*>(s_w[wi][src[p]]);
                  x = gather_op<T, GW>(x, __uint_as_float(wts[c]), 0);
                }
                acc = combine<T, R>(acc, x);
                any = true;
              }
            }
          }
        }
        __syncwarp();                        // before the next step's rows
      }
    }
  }
  flush();
}

// (c) 2L's flags built on the card from the lanes' touched tables, in two
// passes.  First a lane word a vertex: bit l set where lane l's touched
// table (row map.row[l] of the (k', V) bytes) holds a nonzero byte; word V
// (the pad sub-rows' owner) is 0.  A thread takes four vertices u0 .. u0 +
// 3: with `vec` (V a multiple of 4 and the table on 4-byte boundaries) one
// 4-byte read of each lane's bytes, else (and for the last V % 4 vertices)
// a byte read a vertex; its four words as one 16-byte store where they lie
// inside the (V + 1,) table and vword is on 16-byte boundaries.
__global__ void lanes_vertex_words_kernel(const uint8_t* __restrict__ touched,
                                          LaneMap map, int k, long long V,
                                          bool vec,
                                          unsigned* __restrict__ vword) {
  const long long u0 = 4 * (blockIdx.x * static_cast<long long>(blockDim.x) +
                            threadIdx.x);
  if (u0 > V) return;
  unsigned w[4] = {0u, 0u, 0u, 0u};
  const bool whole = vec && u0 + 4 <= V;
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < k) {
      const uint8_t* row = touched + map.row[l] * V + u0;
      unsigned a = 0u;
      if (whole) {
        a = *reinterpret_cast<const unsigned*>(row);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (u0 + i < V) a |= static_cast<unsigned>(row[i]) << (8 * i);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] |= (((a >> (8 * i)) & 0xffu) != 0u ? 1u : 0u) << l;
      }
    }
  }
  if (u0 + 4 <= V + 1 && reinterpret_cast<uintptr_t>(vword) % 16 == 0) {
    *reinterpret_cast<uint4*>(vword + u0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (u0 + i <= V) vword[u0 + i] = w[i];
    }
  }
}

// Then a warp a grid block ORs its sub-rows' owners' words (the (V + 1,)
// words, 16.8 MB at scale 22, stay in L2; a thread reads an owner's word
// once a run) and sets the `wide` lanes' bits in every word: words[b].  With
// counters, each narrow lane l (its bit of `wide` 0) whose bit is set adds
// grid_blocks[b] and grid_edges[b] (the plan blocks and edges of grid block
// b) to counters[l] and counters[k + l], summed a thread over the warp's
// grid blocks, then in shared memory, then once a CTA into the table.
__global__ void __launch_bounds__(256) lanes_block_words_kernel(
    const int* __restrict__ owner8, const unsigned* __restrict__ vword,
    long long rows, long long block_rows, long long nblk, unsigned wide,
    int k, unsigned* __restrict__ words,
    const long long* __restrict__ grid_blocks,
    const long long* __restrict__ grid_edges,
    unsigned long long* __restrict__ counters) {
  __shared__ unsigned long long sums[2 * kMaxLanes];
  const bool count = counters != nullptr;
  if (count) {
    if (threadIdx.x < 2 * kMaxLanes) sums[threadIdx.x] = 0ull;
    __syncthreads();
  }
  const int t = threadIdx.x & 31;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  unsigned long long nb = 0ull, ne = 0ull;
  for (long long b = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) >> 5;
       b < nblk; b += warps) {
    const long long r0 = b * block_rows;
    const long long r1 = min(rows, r0 + block_rows);
    unsigned w = 0u;
    int prev = -1;
    for (long long r = r0 + t; r < r1; r += 32) {
      const int o = __ldg(owner8 + r);
      if (o != prev) {
        w |= __ldg(vword + o);
        prev = o;
      }
    }
    w = __reduce_or_sync(~0u, w) | wide;
    if (t == 0) words[b] = w;
    if (count && t < k && !((wide >> t) & 1u) && ((w >> t) & 1u)) {
      nb += static_cast<unsigned long long>(grid_blocks[b]);
      ne += static_cast<unsigned long long>(grid_edges[b]);
    }
  }
  if (count) {
    if (nb != 0ull) atomicAdd(&sums[t], nb);
    if (ne != 0ull) atomicAdd(&sums[kMaxLanes + t], ne);
    __syncthreads();
    if (threadIdx.x < 2 * kMaxLanes) {
      const int l = threadIdx.x % kMaxLanes;
      const unsigned long long v = sums[threadIdx.x];
      if (l < k && v != 0ull) {
        atomicAdd(counters + (threadIdx.x / kMaxLanes) * k + l, v);
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
  long long block_rows;
  const void* words;        // nblk words, the launch's flags (2L); null: no
                            // flags (1L)
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
    const unsigned* words = static_cast<const unsigned*>(a.words);
    if constexpr (std::is_same<Out, SubRowOut>::value) {
      edge_block_lanes_kernel<T, GW, R, K>
          <<<blocks, kThreads, 0, a.stream>>>(
              nbr, wgt, bits, msg, words, a.block_rows,
              static_cast<T*>(o.out), static_cast<uint8_t*>(o.any), a.rows,
              a.width, a.k, a.mask, w8);
    } else if (words != nullptr) {
      // 2L: a warp a grid block, on the flat width-8 view under
      // mask_inactive
      if (!a.mask || !w8) return cudaErrorInvalidValue;
      const long long nblk = (a.rows + a.block_rows - 1) / a.block_rows;
      edge_block_skip_fold_kernel<T, GW, R, K>
          <<<(nblk * 32 + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
             a.stream>>>(
              nbr, wgt, static_cast<const int*>(o.owner8), bits, msg, words,
              a.block_rows, nblk, a.map, static_cast<T*>(o.red),
              static_cast<uint8_t*>(o.got), a.rows, a.V, a.k,
              o.accumulate);
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
// Non-null `words` (ceil(rows / block_rows) words; bit l of word b: lane
// lanes[l] reads grid block b) selects 2L; null, 1L.  `stage` as
// edge_block_reduce_launch's; under mask_inactive the pre-pass writes the
// messages of vertices active in some lane only (lanes.cuh).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int edge_block_lanes_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    int K, const void* nbr, const void* wgt, const void* values,
    const void* degrees, const void* active, const int* lanes, int k,
    long long lane_rows, void* bits, void* msg, long long V, void* out,
    void* any, long long rows, int width, long long block_rows,
    const void* words, int stage, void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (!make_lane_map(lanes, k, K, lane_rows, &map) || !valid_stage(stage) ||
      (words != nullptr && block_rows < 1)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const LaneArgs a{mask_inactive != 0, nbr, wgt, values, degrees, active,
                   map, bits, msg, V, k, rows, width, block_rows, words,
                   stage, static_cast<cudaStream_t>(stream)};
  const SubRowOut o{out, any};
  return value_is_float ? lanes_by_gather<float>(a, o, gather, reduce, K)
                        : lanes_by_gather<int>(a, o, gather, reduce, K);
}

// C entry point of the fold kernel, for min, max and int32 add: the lanes
// kernel's inputs, and owner8, the flat view's (rows,) owner vertices (V
// for pad sub-rows).  `red` is (lane_rows, V) of the value type holding
// the reduce identity in the listed rows on entry, `got` (lane_rows, V)
// bytes holding 0 there, or null; with `accumulate` they hold running
// partials instead, which the launch combines into.  `block_rows` and
// `words` as edge_block_lanes_launch's (2L: the warp-a-grid-block kernel,
// which needs mask_inactive and the width-8 view on 16-byte boundaries).
// `stage` as edge_block_reduce_launch's.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int edge_block_fold_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    int K, const void* nbr, const void* wgt, const void* owner8,
    const void* values, const void* degrees, const void* active,
    const int* lanes, int k, long long lane_rows, void* bits, void* msg,
    long long V, void* red, void* got, long long rows, int width,
    int accumulate, long long block_rows, const void* words, int stage,
    void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (owner8 == nullptr || !make_lane_map(lanes, k, K, lane_rows, &map) ||
      !valid_stage(stage) || (words != nullptr && block_rows < 1)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const LaneArgs a{mask_inactive != 0, nbr, wgt, values, degrees, active,
                   map, bits, msg, V, k, rows, width, block_rows, words,
                   stage, static_cast<cudaStream_t>(stream)};
  const FoldOut o{owner8, red, got, accumulate != 0};
  return value_is_float ? lanes_by_gather<float>(a, o, gather, reduce, K)
                        : lanes_by_gather<int>(a, o, gather, reduce, K);
}

// C entry point of 2L's flags pass (c): from the (lane_rows, V) touched
// bytes of the k rows listed in `lanes` (1 <= k <= 32) and owner8 ((rows,)
// owner vertices, V for pad sub-rows), one word a grid block of block_rows
// sub-rows into `words` (ceil(rows / block_rows) words), bit l set where
// lane lanes[l] touches an owner of the block or bit l of `wide` is set;
// `vword` ((V + 1,) words) is scratch.  With `counters` ((2, k) int64,
// zero on entry; null: none), each lane l outside `wide` adds the
// grid_blocks and grid_edges entries ((nblk,) int64 each) of its live
// blocks to counters[0][l] and counters[1][l].  Returns the cudaError_t of
// the launches (0 = success).
extern "C" int edge_block_words_launch(
    int device, const void* touched, const int* lanes, int k,
    long long lane_rows, long long V, const void* owner8, long long rows,
    long long block_rows, unsigned wide, void* vword, void* words,
    const void* grid_blocks, const void* grid_edges, void* counters,
    void* stream) {
  using namespace repro_torch;
  constexpr int kThreads = 256;
  LaneMap map;
  if (!make_lane_map(lanes, k, kMaxLanes, lane_rows, &map) ||
      block_rows < 1 || owner8 == nullptr || vword == nullptr ||
      words == nullptr ||
      (counters != nullptr &&
       (grid_blocks == nullptr || grid_edges == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec =
      V % 4 == 0 && reinterpret_cast<uintptr_t>(touched) % 4 == 0;
  lanes_vertex_words_kernel<<<(V / 4 + 1 + kThreads - 1) / kThreads,
                              kThreads, 0, st>>>(
      static_cast<const uint8_t*>(touched), map, k, V, vec,
      static_cast<unsigned*>(vword));
  err = cudaGetLastError();
  if (err != cudaSuccess || rows == 0) return err;
  const long long nblk = (rows + block_rows - 1) / block_rows;
  const long long need = (nblk * 32 + kThreads - 1) / kThreads;
  const long long ctas = need < 1056 ? need : 1056;   // 8 CTAs an SM
  lanes_block_words_kernel<<<ctas, kThreads, 0, st>>>(
      static_cast<const int*>(owner8), static_cast<const unsigned*>(vword),
      rows, block_rows, nblk, wide, k, static_cast<unsigned*>(words),
      static_cast<const long long*>(grid_blocks),
      static_cast<const long long*>(grid_edges),
      static_cast<unsigned long long*>(counters));
  return cudaGetLastError();
}
