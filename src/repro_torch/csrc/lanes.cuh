// Device helpers shared by kernel 1 and the lane-axis kernels (the lane
// sweeps in edge_block.cu, the lane push in push_ell.cu, the streamed
// fold in stream_fold.cu): cache-hinted loads, the lane map, the pre-pass
// that lays k lanes of a (k', V) state out vertex-major, and the lane
// sweeps' read of one row's slots into k lanes' partials (lanes_row).
//
// A lane map names the rows of a lane-major (k', V) state that one launch
// takes, in lane order: lane l of the launch is row map.row[l].  It goes
// to the kernels by value, in the launch's parameters (up to 32 lanes), so
// a launch reads and writes the state's rows in place and no index tensor
// is copied to the device.
#pragma once

#include "gather_ops.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxLanes = 32;

// What a call of a C entry launches: the pre-pass alone (its tables
// written to scratch the caller keeps), or the main kernel alone on the
// tables a pre-pass call wrote for the same state.  The wrappers run the
// pre-pass before each main launch they are given no tables for; the
// streamed engine runs it once a superstep and the main kernel once a
// partition.
enum Stage { kPackOnly = 0, kMainOnly = 1 };

inline bool valid_stage(int stage) {
  return stage == kPackOnly || stage == kMainOnly;
}

struct LaneMap {
  int row[kMaxLanes];
};

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
// 4 bytes of a table this very kernel writes (the test read before an
// atomic): from L2, never a stale copy in L1, with an L2 policy
__device__ __forceinline__ unsigned load_kept(const void* p, uint64_t pol) {
  unsigned r;
  asm volatile("ld.global.cg.L2::cache_hint.u32 %0, [%1], %2;"
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

// The K frontier bits of vertex id (32 / K vertices a word)
template <int K>
__device__ __forceinline__ unsigned lane_bits(const unsigned* bits, int id,
                                              uint64_t pol) {
  constexpr unsigned kAll = K == 32 ? ~0u : (1u << K) - 1u;
  const long long at = static_cast<long long>(id) * K;
  return (load_table(bits + (at >> 5), pol) >> (at & 31)) & kAll;
}

// The pre-pass, one thread a vertex u: under `mask`, u's K frontier bits
// (bit l = lane l's active[u]), packed 32 / K vertices a word (K = 1 is
// kernel 1's bitmap); with kMsg, the K lanes' messages of u in one
// vertex-major row msg[u * K .. u * K + K) (for K = 8 and 4-byte values,
// one 32-byte sector): the gather's message for plus_one and div_deg,
// with the same _rn arithmetic as the single-lane kernels, else the value.
// Lane l reads row map.row[l] of the (k', V) values and active.  Pad
// lanes (k <= l < K) get message 0 and frontier bit 0.
//
// Under `mask` the row of messages is written only for a vertex active in
// some lane of the launch, and its values are read only then; other rows
// are left as they were (unwritten scratch).  That is exact for every
// masked launch of every kernel that reads these tables: each reads
// msg[u * K + l] only where u's frontier bit of lane l is set (a kernel
// that loads the whole row, the sub-row kernel's lanes_row, loads it only
// where some bit of u is set, and uses only the set lanes' words), so no
// unwritten entry is ever read.  An unmasked launch reads every vertex's
// row, and then every row is written.  On narrow frontiers it reads the
// launch's active bytes once (k x V B) where the full table writes k x V x
// 4 B of messages and reads as many values.
template <typename T, int G, int K, bool kMsg>
__global__ void lanes_pack_kernel(const T* __restrict__ values,
                                  const int* __restrict__ degrees,
                                  const uint8_t* __restrict__ active,
                                  LaneMap map, unsigned* __restrict__ bits,
                                  T* __restrict__ msg, long long V, int k,
                                  bool mask) {
  constexpr bool kNeedsMsg = G == kPlusOne || G == kDivDeg;
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  unsigned live = 0;
  if (mask) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (u < V && l < k && active[map.row[l] * V + u] != 0) live |= 1u << l;
    }
  }
  // under mask the messages of a vertex no lane of the launch holds active
  // are never read (see above), so they are neither read nor written
  const bool write = u < V && (!mask || live != 0u);
  unsigned row[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    row[l] = 0u;
    if constexpr (kMsg) {
      if (write && l < k) {
        const T v = values[map.row[l] * V + u];
        row[l] = to_bits<T>(
            kNeedsMsg ? gather_op<T, G>(v, 0.0f,
                                        G == kDivDeg ? degrees[u] : 0)
                      : v);
      }
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
  if constexpr (kMsg) {
    if (!write) return;
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

// The pre-pass at K = 1 on 16-byte vectors: one thread four vertices
// 4 q .. 4 q + 3 (their values, degrees and messages as one vector each,
// their frontier bytes as one word), and a frontier word built from 8
// threads' 4 bits by three shuffles; the same tables as lanes_pack_kernel.
// Under mask, the active vertices' messages alone (a vector store when all
// four are).  Needs V a multiple of 4 and the lane's rows on the
// vectors' grid.
template <typename T, int G, bool kMsg>
__global__ void lanes_pack4_kernel(const T* __restrict__ values,
                                   const int* __restrict__ degrees,
                                   const uint8_t* __restrict__ active,
                                   LaneMap map, unsigned* __restrict__ bits,
                                   T* __restrict__ msg, long long V,
                                   bool mask) {
  constexpr bool kNeedsMsg = G == kPlusOne || G == kDivDeg;
  const long long u0 = 4 * (blockIdx.x * static_cast<long long>(blockDim.x) +
                            threadIdx.x);
  const bool in = u0 < V;
  const long long at = map.row[0] * V + u0;
  unsigned live = 0u;
  if (mask) {
    if (in) {
      const unsigned a = *reinterpret_cast<const unsigned*>(active + at);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        live |= (((a >> (8 * i)) & 0xffu) != 0u ? 1u : 0u) << i;
      }
    }
    const int t = threadIdx.x & 31;
    unsigned word = live << ((t & 7) * 4);
    word |= __shfl_xor_sync(~0u, word, 1);
    word |= __shfl_xor_sync(~0u, word, 2);
    word |= __shfl_xor_sync(~0u, word, 4);
    if ((t & 7) == 0 && in) bits[u0 >> 5] = word;
  }
  if constexpr (kMsg) {
    if (!in || (mask && live == 0u)) return;
    const uint4 v = *reinterpret_cast<const uint4*>(values + at);
    unsigned r[4] = {v.x, v.y, v.z, v.w};
    if constexpr (kNeedsMsg) {
      int d[4] = {0, 0, 0, 0};
      if constexpr (G == kDivDeg) {
        const int4 dv = *reinterpret_cast<const int4*>(degrees + u0);
        d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = to_bits<T>(gather_op<T, G>(from_bits<T>(r[i]), 0.0f, d[i]));
      }
    }
    if (!mask || live == 0xfu) {
      *reinterpret_cast<uint4*>(msg + u0) =
          make_uint4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((live >> i) & 1u) {
          reinterpret_cast<unsigned*>(msg)[u0 + i] = r[i];
        }
      }
    }
  }
}

template <typename T, int G, int K, bool kMsg>
cudaError_t launch_lanes_pack(const T* values, const int* degrees,
                              const uint8_t* active, const LaneMap& map,
                              unsigned* bits, T* msg, long long V, int k,
                              bool mask, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (V == 0 || (!mask && !kMsg)) return cudaSuccess;
  auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (K == 1 && V % 4 == 0 &&
      (!mask || reinterpret_cast<uintptr_t>(active) % 4 == 0) &&
      (!kMsg || (on16(values) && on16(msg) &&
                 (G != kDivDeg || on16(degrees))))) {
    const long long blocks = (V / 4 + kThreads - 1) / kThreads;
    lanes_pack4_kernel<T, G, kMsg><<<blocks, kThreads, 0, stream>>>(
        values, degrees, active, map, bits, msg, V, mask);
    return cudaGetLastError();
  }
  const long long blocks = (V + kThreads - 1) / kThreads;
  lanes_pack_kernel<T, G, K, kMsg><<<blocks, kThreads, 0, stream>>>(
      values, degrees, active, map, bits, msg, V, k, mask);
  return cudaGetLastError();
}

// A lane map from the host's int array; 1 <= k <= K <= 32, every row in
// [0, rows_total).  Returns false if the map is out of range.
inline bool make_lane_map(const int* lanes, int k, int K, long long rows_total,
                          LaneMap* map) {
  if (k < 1 || k > K || K > kMaxLanes || lanes == nullptr) return false;
  for (int l = 0; l < kMaxLanes; ++l) {
    const int row = l < k ? lanes[l] : 0;
    if (row < 0 || row >= rows_total) return false;
    map->row[l] = row;
  }
  return true;
}

// Gathers that apply a slot's weight, and those whose message is not the
// value itself (these get a message table from the pre-pass).
__host__ __device__ constexpr bool weighted(int g) {
  return g == kAddW || g == kMulW;
}
__host__ __device__ constexpr bool needs_msg(int g) {
  return g == kPlusOne || g == kDivDeg;
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

// One sub-row's partials: acc[l] is lane l's reduce over the row's slots,
// bit l of any whether lane l had a live slot.  Only the lanes whose bit
// is set in `on` read the row (2L's block flags): in the others every slot
// is dead, so they keep the identity, any 0, and read no message.
template <typename T, int GW, int R, int K>
__device__ __forceinline__ void lanes_row(const int* __restrict__ nbr,
                                          const float* __restrict__ wgt,
                                          const unsigned* __restrict__ bits,
                                          const T* __restrict__ msg,
                                          long long r, int width, bool mask,
                                          bool w8, T (&acc)[K],
                                          unsigned& any, unsigned on = ~0u) {
  constexpr bool kW = weighted(GW);
  const unsigned all_on = (K == 32 ? ~0u : (1u << K) - 1u) & on;
  const uint64_t first = l2_policy_evict_first();
  const uint64_t last = l2_policy_evict_last();
  if (w8) {
    const int4 lo = load_stream(nbr + r * 8, first);
    const int4 hi = load_stream(nbr + r * 8 + 4, first);
    const int ids[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {        // the row's frontier bits in flight
      live[j] = ids[j] == kPad ? 0u
                : mask          ? lane_bits<K>(bits, ids[j], last) & on
                                : all_on;
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
                            : mask    ? lane_bits<K>(bits, u, last) & on
                                      : all_on;
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
}

}  // namespace
}  // namespace repro_torch
