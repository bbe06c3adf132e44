// Device helpers shared by kernel 1 and the lane-axis kernels (the lane
// sweeps in edge_block.cu, the lane push in push_ell.cu): cache-hinted
// loads, the lane map, and the pre-pass that lays k lanes of a (k', V)
// state out vertex-major.
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
  unsigned row[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    row[l] = 0u;
    if (u < V && l < k) {
      const long long at = map.row[l] * V + u;
      if constexpr (kMsg) {
        const T v = values[at];
        row[l] = to_bits<T>(
            kNeedsMsg ? gather_op<T, G>(v, 0.0f,
                                        G == kDivDeg ? degrees[u] : 0)
                      : v);
      }
      if (mask && active[at] != 0) live |= 1u << l;
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
    if (u >= V) return;
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

template <typename T, int G, int K, bool kMsg>
cudaError_t launch_lanes_pack(const T* values, const int* degrees,
                              const uint8_t* active, const LaneMap& map,
                              unsigned* bits, T* msg, long long V, int k,
                              bool mask, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (V == 0 || (!mask && !kMsg)) return cudaSuccess;
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

}  // namespace
}  // namespace repro_torch
