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
