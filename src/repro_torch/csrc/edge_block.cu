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
#include "gather_ops.cuh"

namespace repro_torch {
namespace {

// Gathers that apply a slot's weight, and those whose message is not the
// value itself (these get a message table from the pre-pass).
__host__ __device__ constexpr bool weighted(int g) {
  return g == kAddW || g == kMulW;
}
__host__ __device__ constexpr bool needs_msg(int g) {
  return g == kPlusOne || g == kDivDeg;
}

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

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
// 16 bytes of the id (or weight) stream: not kept in L1, first out of L2
__device__ __forceinline__ int4 load_stream(const void* p, uint64_t pol) {
  int4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0,%1,%2,%3}, "
      "[%4], %5;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(pol));
  return r;
}
// 4 bytes of a vertex table (frontier bits or messages), kept in L2
// ahead of the stream
__device__ __forceinline__ unsigned load_table(const void* p, uint64_t pol) {
  unsigned r;
  asm volatile("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(r)
               : "l"(p), "l"(pol));
  return r;
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned x) {
  if constexpr (std::is_floating_point<T>::value) {
    return __uint_as_float(x);
  } else {
    return static_cast<int>(x);
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
  if ((kMask || kMsg) && a.V > 0) {
    const long long blocks = (a.V + kThreads - 1) / kThreads;
    edge_block_pack_kernel<T, G, kMask, kMsg>
        <<<blocks, kThreads, 0, a.stream>>>(
            static_cast<const T*>(a.values),
            static_cast<const int*>(a.degrees),
            static_cast<const uint8_t*>(a.active),
            static_cast<unsigned*>(a.bits), static_cast<T*>(a.msg), a.V);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
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
// The lane-axis variant: kernel 1 over k lanes at once (k frontiers and
// value tables over one graph, as the vmapped Pallas kernel runs under the
// JAX package's batched runs).  K is k rounded up to 1, 4, 8 or 32 (the
// wrapper splits wider batches into launches of 32 lanes); mask_inactive
// is a launch argument, not a template one, to keep the build short.
//
// Pre-pass, one thread a vertex u: the K lanes' messages of u in one
// vertex-major row msg[u * K .. u * K + K) (for K = 8 and 4-byte values,
// one 32-byte sector), and under mask_inactive u's K frontier bits,
// packed 32 / K vertices a word (K = 1 is kernel 1's bitmap).  Pad lanes
// (k <= l < K) get message 0 and frontier bit 0.
//
// Main kernel, one thread a row: the row's ids are read once, as kernel
// 1 reads them; per slot one read of the vertex's K frontier bits and,
// when any lane is live there, one read of its K messages; each lane
// reduces the row's slots in slot order with the dead slots as the
// identity, exactly as kernel 1 reduces one lane, so a lane's float add
// sums in kernel 1's order.  Outputs are lane-major (k, rows).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ unsigned to_bits(T x) {
  if constexpr (std::is_floating_point<T>::value) {
    return __float_as_uint(x);
  } else {
    return static_cast<unsigned>(x);
  }
}

// K consecutive 4-byte words from p (aligned to min(16, 4 K) bytes), kept
// in L2 ahead of the id stream.
template <int K>
__device__ __forceinline__ void load_lanes(const void* p, uint64_t pol,
                                           unsigned (&m)[K]) {
  if constexpr (K == 1) {
    m[0] = load_table(p, pol);
  } else if constexpr (K == 2) {
    asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0,%1}, [%2], %3;"
                 : "=r"(m[0]), "=r"(m[1])
                 : "l"(p), "l"(pol));
  } else {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      asm volatile(
          "ld.global.nc.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;"
          : "=r"(m[4 * q]), "=r"(m[4 * q + 1]), "=r"(m[4 * q + 2]),
            "=r"(m[4 * q + 3])
          : "l"(static_cast<const unsigned*>(p) + 4 * q), "l"(pol));
    }
  }
}

template <typename T, int G, int K>
__global__ void edge_block_lanes_pack_kernel(
    const T* __restrict__ values, const int* __restrict__ degrees,
    const uint8_t* __restrict__ active, unsigned* __restrict__ bits,
    T* __restrict__ msg, long long V, int k, bool mask) {
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  unsigned live = 0;
  unsigned row[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    row[l] = 0u;
    if (u < V && l < k) {
      const T v = values[l * V + u];
      row[l] = to_bits<T>(needs_msg(G)
                              ? gather_op<T, G>(v, 0.0f,
                                                G == kDivDeg ? degrees[u] : 0)
                              : v);
      if (mask && active[l * V + u] != 0) live |= 1u << l;
    }
  }
  if (mask) {
    // 32 / K consecutive threads (vertices) share a word
    constexpr int kPer = 32 / K;
    const int t = threadIdx.x & 31;
    unsigned word = K == 32 ? live : live << ((t * K) & 31);
#pragma unroll
    for (int off = 1; off < kPer; off <<= 1) {
      word |= __shfl_xor_sync(~0u, word, off);
    }
    if (t % kPer == 0 && u < V) bits[(u * K) >> 5] = word;
  }
  if (u < V) {
    unsigned* dst = reinterpret_cast<unsigned*>(msg) + u * K;
    if constexpr (K == 1) {
      dst[0] = row[0];
    } else if constexpr (K == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(row[0], row[1]);
    } else {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        reinterpret_cast<uint4*>(dst)[q] = make_uint4(
            row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
      }
    }
  }
}

// One slot into the K lanes' accumulators: lanes whose bit is set in
// `live` take the message (weighted by w for add_w and mul_w), the others
// the identity, in lane order.
template <typename T, int GW, int R, int K>
__device__ __forceinline__ void lanes_combine(T (&acc)[K], unsigned live,
                                              const unsigned (&m)[K],
                                              float w) {
  const T ident = reduce_identity<T, R>();
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T x = ident;
    if ((live >> l) & 1u) {
      x = from_bits<T>(m[l]);
      if constexpr (weighted(GW)) x = gather_op<T, GW>(x, w, 0);
    }
    acc[l] = combine<T, R>(acc[l], x);
  }
}

template <int K>
__device__ __forceinline__ unsigned lane_bits(const unsigned* bits, int id,
                                              uint64_t pol) {
  constexpr unsigned kAll = K == 32 ? ~0u : (1u << K) - 1u;
  const long long at = static_cast<long long>(id) * K;
  return (load_table(bits + (at >> 5), pol) >> (at & 31)) & kAll;
}

template <typename T, int GW, int R, int K>
__global__ void edge_block_lanes_kernel(const int* __restrict__ nbr,
                                        const float* __restrict__ wgt,
                                        const unsigned* __restrict__ bits,
                                        const T* __restrict__ msg,
                                        T* __restrict__ out,
                                        uint8_t* __restrict__ any_out,
                                        long long rows, int width, int k,
                                        bool mask, bool w8) {
  constexpr bool kW = weighted(GW);
  constexpr unsigned kAll = K == 32 ? ~0u : (1u << K) - 1u;
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const uint64_t first = l2_policy_evict_first();
  const uint64_t last = l2_policy_evict_last();
  T acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = reduce_identity<T, R>();
  unsigned any = 0;
  if (w8) {
    const int4 lo = load_stream(nbr + r * 8, first);
    const int4 hi = load_stream(nbr + r * 8 + 4, first);
    const int ids[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {        // the row's frontier bits in flight
      live[j] = ids[j] == kPad ? 0u
                : mask          ? lane_bits<K>(bits, ids[j], last)
                                : kAll;
    }
    float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (kW) {
      const int4 wl = load_stream(wgt + r * 8, first);
      const int4 wh = load_stream(wgt + r * 8 + 4, first);
      const int wb[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = __int_as_float(wb[j]);
    }
    if constexpr (K <= 8) {              // then all live rows of messages
      unsigned m[8][K];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (live[j]) {
          load_lanes<K>(msg + static_cast<long long>(ids[j]) * K, last,
                        m[j]);
        } else {
#pragma unroll
          for (int l = 0; l < K; ++l) m[j][l] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lanes_combine<T, GW, R, K>(acc, live[j], m[j], w[j]);
        any |= live[j];
      }
    } else {                             // wide rows: a slot at a time
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned m[K];
        if (live[j]) {
          load_lanes<K>(msg + static_cast<long long>(ids[j]) * K, last, m);
        } else {
#pragma unroll
          for (int l = 0; l < K; ++l) m[l] = 0u;
        }
        lanes_combine<T, GW, R, K>(acc, live[j], m, w[j]);
        any |= live[j];
      }
    }
  } else {
    const int* row = nbr + r * width;
    const float* wrow = wgt + r * width;
    for (int j = 0; j < width; ++j) {
      const int u = __ldg(row + j);
      const unsigned live = u == kPad ? 0u
                            : mask    ? lane_bits<K>(bits, u, last)
                                      : kAll;
      unsigned m[K];
      if (live) {
        load_lanes<K>(msg + static_cast<long long>(u) * K, last, m);
      } else {
#pragma unroll
        for (int l = 0; l < K; ++l) m[l] = 0u;
      }
      lanes_combine<T, GW, R, K>(acc, live, m,
                                 kW ? __ldg(wrow + j) : 0.0f);
      any |= live;
    }
  }
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < k) {
      out[l * rows + r] = acc[l];
      if (any_out != nullptr) any_out[l * rows + r] = (any >> l) & 1u;
    }
  }
}

struct LaneArgs {
  bool mask;                // mask_inactive
  const void* nbr;
  const void* wgt;
  const void* values;       // (k, V), lane-major
  const void* degrees;
  const void* active;       // (k, V) bool
  void* bits;               // ceil(V K / 32) words (mask_inactive)
  void* msg;                // (V, K) vertex-major messages
  long long V;
  int k;
  void* out;                // (k, rows)
  void* any;                // (k, rows) bytes, or null
  long long rows;
  int width;
  cudaStream_t stream;
};

template <typename T, int G, int R, int K>
cudaError_t launch_lanes(const LaneArgs& a) {
  constexpr int kThreads = 256;
  constexpr int GW = weighted(G) ? G : kCopy;   // the main kernel's gather
  if (a.V > 0) {
    const long long blocks = (a.V + kThreads - 1) / kThreads;
    edge_block_lanes_pack_kernel<T, G, K>
        <<<blocks, kThreads, 0, a.stream>>>(
            static_cast<const T*>(a.values),
            static_cast<const int*>(a.degrees),
            static_cast<const uint8_t*>(a.active),
            static_cast<unsigned*>(a.bits), static_cast<T*>(a.msg), a.V,
            a.k, a.mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool w8 = a.width == 8 &&
                  reinterpret_cast<uintptr_t>(a.nbr) % 16 == 0 &&
                  (!weighted(G) ||
                   reinterpret_cast<uintptr_t>(a.wgt) % 16 == 0);
  const long long blocks = (a.rows + kThreads - 1) / kThreads;
  edge_block_lanes_kernel<T, GW, R, K>
      <<<blocks, kThreads, 0, a.stream>>>(
          static_cast<const int*>(a.nbr), static_cast<const float*>(a.wgt),
          static_cast<const unsigned*>(a.bits),
          static_cast<const T*>(a.msg), static_cast<T*>(a.out),
          static_cast<uint8_t*>(a.any), a.rows, a.width, a.k, a.mask, w8);
  return cudaGetLastError();
}

template <typename T, int G, int R>
cudaError_t lanes_by_k(const LaneArgs& a, int K) {
  switch (K) {
    case 1: return launch_lanes<T, G, R, 1>(a);
    case 4: return launch_lanes<T, G, R, 4>(a);
    case 8: return launch_lanes<T, G, R, 8>(a);
    case 32: return launch_lanes<T, G, R, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G>
cudaError_t lanes_by_reduce(const LaneArgs& a, int reduce, int K) {
  switch (reduce) {
    case kAdd: return lanes_by_k<T, G, kAdd>(a, K);
    case kMin: return lanes_by_k<T, G, kMin>(a, K);
    case kMax: return lanes_by_k<T, G, kMax>(a, K);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t lanes_by_gather(const LaneArgs& a, int gather, int reduce,
                            int K) {
  switch (gather) {
    case kCopy: return lanes_by_reduce<T, kCopy>(a, reduce, K);
    case kPlusOne: return lanes_by_reduce<T, kPlusOne>(a, reduce, K);
    case kAddW: return lanes_by_reduce<T, kAddW>(a, reduce, K);
    case kMulW: return lanes_by_reduce<T, kMulW>(a, reduce, K);
    case kDivDeg:
      if constexpr (std::is_floating_point<T>::value) {
        return lanes_by_reduce<T, kDivDeg>(a, reduce, K);
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
// the block-skipping variant over blocks of block_rows rows.  `bits`
// (ceil(V / 32) int32 words, with mask_inactive) and `msg` ((V,) of the
// value type, for plus_one and div_deg) are scratch for the pre-pass, null
// where unused.  Returns the cudaError_t of the launches (0 = success).
extern "C" int edge_block_reduce_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    const void* block_live, long long block_rows, const void* nbr,
    const void* wgt, const void* values, const void* degrees,
    const void* active, void* bits, void* msg, long long V, void* out,
    void* any,
    long long rows, int width, void* stream) {
  using namespace repro_torch;
  if (block_live != nullptr && block_rows < 1) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  const Args a{block_live, block_rows, nbr, wgt, values, degrees, active,
               bits, msg, V, out, any, rows, width,
               static_cast<cudaStream_t>(stream)};
  return value_is_float ? by_gather<float>(a, gather, reduce, mask_inactive)
                        : by_gather<int>(a, gather, reduce, mask_inactive);
}

// C entry point of the lane-axis variant.  values and active are (k, V)
// lane-major, 1 <= k <= K; K is 1, 4, 8 or 32.  `bits` (ceil(V K /
// 32) words, with mask_inactive) and `msg` ((V, K) of the value type) are
// scratch for the pre-pass; `out` is (k, rows) of the value type and
// `any` (k, rows) bytes, or null when the caller needs no flags.  Returns
// the cudaError_t of the launches (0 = success).
extern "C" int edge_block_lanes_launch(
    int device, int gather, int reduce, int value_is_float, int mask_inactive,
    int K, const void* nbr, const void* wgt, const void* values,
    const void* degrees, const void* active, void* bits, void* msg,
    long long V, int k, void* out, void* any, long long rows, int width,
    void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > K) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  const LaneArgs a{mask_inactive != 0, nbr, wgt, values, degrees, active,
                   bits, msg, V, k, out, any, rows, width,
                   static_cast<cudaStream_t>(stream)};
  return value_is_float ? lanes_by_gather<float>(a, gather, reduce, K)
                        : lanes_by_gather<int>(a, gather, reduce, K);
}
