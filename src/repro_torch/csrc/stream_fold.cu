// The streamed engine's float-add pull partial: one partition's rows
// gathered, summed and folded by owner into the running (k', V) table, in
// one launch and a carry fold.
//
// Replaces the route of kernel 1 (repro/kernels/edge_block.py::_kernel,
// ported in edge_block.cu) for the per-row sums, then kernel 4
// (repro/kernels/segment_sum.py::_kernel, ported in segment_sum.cu)
// folding them by owner into a (V,) partial, then the partial added to
// the running table: the counterpart, for a float add, of the jitted
// per-partition jax.ops.segment_sum and the partials' combine in
// repro/core/stream.py.  Input: a partition's (R, W) slot ids (PAD-padded)
// and weights, its (R,) owners (equal owners in consecutive rows; owners
// outside [0, V) are dropped), the lane pre-pass's tables (lanes.cuh,
// lanes_pack_kernel) and a lane map of k <= K lanes, K in {1, 4, 8, 32}.
// Output: for each lane l and each owner o with rows in the partition,
// red[row(l), o] = red[row(l), o] + (the sum of o's rows), and got[row(l),
// o] = 1 where one of those rows has a live slot.  The plain version is
// repro_torch/kernels/edge_block.py::edge_block_add_fold_lanes_plain.
//
// What bounds it on an H100: bytes.  The function must read each row's 8
// ids and its owner once (36 B a row), each live source's message once,
// and read and write each touched owner's running entry (and write its
// got byte): on pagerank's largest pull partition at scale 20 (451,959
// rows, 275,244 owners, every source live) about 18.5 MB, 0.0055 ms at
// 3.35 TB/s.
//
// Design: kernel 4's tile kernel, with kernel 1's row body in place of
// its value loads.  The route it replaces made five launches and two
// allocations a partition and moved an (R,) array of row sums, a (V,)
// partial's fill and write, and a pass over the (V,) table; at this size
// most of its time was the host's.
// - A tile is kThreads = 256 threads x kItems = 8 consecutive rows.  Each
//   thread loads its 8 owners, then (K = 1 at width 8) the 16 id vectors
//   of its 8 rows with the evict-first stream loads, then every live
//   slot's frontier bit, then every live slot's message with the
//   evict-last table loads: 8 rows in flight a thread.  Each row is
//   summed in slot order from +0, the dead slots as +0, exactly as kernel
//   1 sums a row.  With K > 1 (or ids off the 16-byte grid, or another
//   width) a thread reads its rows one at a time through lanes_row, which
//   keeps a row's slots in flight and sums each lane as kernel 1 sums
//   one.
// - Runs of equal owners are reduced as kernel 4 reduces runs of equal
//   ids: a thread's runs in row order, then a block-wide segmented scan
//   (warp shuffles, then the 8 warp totals through shared memory) that
//   carries each thread's open run in from the threads before it, one
//   scan a lane.
// - A run that ends inside the tile and did not come from the previous
//   tile adds its total into the running table: red = red + total, a
//   plain read and store (the k lanes' reads issued together).  An
//   owner's rows are consecutive in a partition, so one thread owns that
//   entry within the launch and no atomic is needed.  A run that crosses
//   tiles goes to kernel 4's per-tile carries (first and last partial a
//   lane, and flags), and the carry fold, one thread a tile and lane,
//   finishes it in tile order and adds it into red the same way.
// - got takes a plain store of 1, a lane at a time, for each run of a
//   thread (a piece of an owner's rows) that has a live slot in that
//   lane: every store writes 1, so their order does not matter.
// - A total of +0 is not added (red + 0 is red wherever red is not -0).
// There is no (R,) or (V,) temporary and no atomic.  The sum's order is
// the replaced route's: each row in slot order from +0, a thread's rows
// in order, the scan's tree, the carries in tile order, then the add into
// red.  A row sum that starts from +0 is never -0, so neither is a total,
// and a running table that starts at +0 holds no -0: the result equals
// the replaced route's bit for bit (chip_smoke.py checks it).  The tiles
// cannot shrink without changing that order, so a partition of R rows is
// ceil(R / 2048) blocks: 221 on pagerank's partition, under two an SM.
#include "lanes.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldBatch = 16;

// per-tile carry flags (segment_sum.cu's)
enum TileFlag { kSingle = 1, kContPrev = 2, kContNext = 4 };

// One step of the segmented scan over K lanes (segment_sum.cu's scan_op):
// the right pair's partials restart where it saw a run head, else they
// extend the left pair's.
template <int K>
__device__ __forceinline__ void scan_op(bool lf, const float (&la)[K],
                                        bool& rf, float (&ra)[K]) {
  if (!rf) {
#pragma unroll
    for (int l = 0; l < K; ++l) ra[l] = add_(la[l], ra[l]);
  }
  rf = lf || rf;
}

// got's stores for one run of a thread: lanes whose bit is set in `live`.
template <int K>
__device__ __forceinline__ void mark_got(uint8_t* got, const LaneMap& map,
                                         int k, int key, long long V,
                                         unsigned live) {
  if (got == nullptr || live == 0u || key < 0 || key >= V) return;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < k && ((live >> l) & 1u)) got[map.row[l] * V + key] = 1;
  }
}

// The ids of rows i0 .. i0 + 7 at width 8: 16 vectors in flight, PAD past
// row n.
__device__ __forceinline__ void ids8(const int* __restrict__ nbr,
                                     long long i0, long long n,
                                     int (&ids)[kItems][8]) {
  const uint64_t first = l2_policy_evict_first();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (i0 + j < n) {
      const int4 lo = load_stream(nbr + (i0 + j) * 8, first);
      const int4 hi = load_stream(nbr + (i0 + j) * 8 + 4, first);
      ids[j][0] = lo.x; ids[j][1] = lo.y; ids[j][2] = lo.z; ids[j][3] = lo.w;
      ids[j][4] = hi.x; ids[j][5] = hi.y; ids[j][6] = hi.z; ids[j][7] = hi.w;
    } else {
#pragma unroll
      for (int s = 0; s < 8; ++s) ids[j][s] = kPad;
    }
  }
}

// One lane's sums of those 8 rows: every live slot's frontier bit in
// flight, then every live slot's message (and the rows' weights); v[j] is
// row j's sum in slot order from +0, bit j of `any` whether it has a live
// slot.
template <int GW>
__device__ __forceinline__ void sums8(const int (&ids)[kItems][8],
                                      const float* __restrict__ wgt,
                                      const unsigned* __restrict__ bits,
                                      const float* __restrict__ msg,
                                      long long i0, long long n, bool mask,
                                      float (&v)[kItems], unsigned& any) {
  constexpr bool kW = weighted(GW);
  const uint64_t first = l2_policy_evict_first();
  const uint64_t last = l2_policy_evict_last();
  unsigned live[kItems];                 // bit s: slot s is live
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    live[j] = 0u;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int u = ids[j][s];
      unsigned b = u != kPad ? 1u : 0u;
      if (mask && b) b = lane_bits<1>(bits, u, last);
      live[j] |= b << s;
    }
  }
  unsigned m[kItems][8];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      m[j][s] = ((live[j] >> s) & 1u) ? load_table(msg + ids[j][s], last)
                                      : 0u;
    }
  }
  float w[kItems][8];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
#pragma unroll
    for (int s = 0; s < 8; ++s) w[j][s] = 0.f;
    if constexpr (kW) {
      if (i0 + j < n) {
        const int4 wl = load_stream(wgt + (i0 + j) * 8, first);
        const int4 wh = load_stream(wgt + (i0 + j) * 8 + 4, first);
        const int wb[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
        for (int s = 0; s < 8; ++s) w[j][s] = __int_as_float(wb[s]);
      }
    }
  }
  any = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float x = 0.f;
      if ((live[j] >> s) & 1u) {
        x = __uint_as_float(m[j][s]);
        if constexpr (kW) x = gather_op<float, GW>(x, w[j][s], 0);
      }
      acc = add_(acc, x);
    }
    v[j] = acc;
    any |= (live[j] != 0u ? 1u : 0u) << j;
  }
}

// What both kernels of a launch share.
struct FoldArgs {
  const int* owner;
  LaneMap map;
  float* red;
  uint8_t* got;
  float* carry_first;        // (k, tiles), lane-major
  float* carry_last;         // (k, tiles)
  int* flags;                // (tiles,)
  long long n;               // rows
  long long V;
  long long tiles;
  int k;
};

// A run's totals into its owner's running entries, lane by lane: the
// reads together, then the sums and stores; a total of +0 is not added.
template <int K>
__device__ __forceinline__ void into_red(const FoldArgs& a, int key,
                                         const float (&total)[K]) {
  float cur[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < a.k && __float_as_uint(total[l]) != 0u) {
      cur[l] = a.red[a.map.row[l] * a.V + key];
    }
  }
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < a.k && __float_as_uint(total[l]) != 0u) {
      a.red[a.map.row[l] * a.V + key] = add_(cur[l], total[l]);
    }
  }
}

// Where a finished run goes (segment_sum.cu's finish_run): the tile's
// first run when it came from the previous tile, or its last when it goes
// on into the next, to the carries; any other into the running table
// (unless its owner is dropped).  The thread that ends the tile's last
// run writes the tile's flags.
template <int K>
__device__ __forceinline__ void finish_run(const FoldArgs& a, int key,
                                           const float (&agg)[K],
                                           bool starts_tile, bool ends_tile,
                                           bool cont_prev, bool cont_next,
                                           long long tile) {
  const bool to_first = starts_tile && cont_prev;
  const bool to_last = ends_tile && cont_next;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l >= a.k) break;
    if (to_first) a.carry_first[l * a.tiles + tile] = agg[l];
    if (to_last) a.carry_last[l * a.tiles + tile] = agg[l];
  }
  if (!to_first && !to_last && key >= 0 && key < a.V) into_red<K>(a, key, agg);
  if (ends_tile) {
    a.flags[tile] = (starts_tile ? kSingle : 0) | (cont_prev ? kContPrev : 0) |
                    (cont_next ? kContNext : 0);
  }
}

template <int GW, int K>
__global__ void __launch_bounds__(kThreads)
    stream_fold_tile_kernel(const int* __restrict__ nbr,
                            const float* __restrict__ wgt,
                            const unsigned* __restrict__ bits,
                            const float* __restrict__ msg, FoldArgs a,
                            int width, bool mask, bool w8, bool vec_keys) {
  __shared__ int s_first[kThreads];     // each thread's first owner
  __shared__ int s_last[kThreads];      // each thread's last owner
  __shared__ bool s_wf[kWarps];         // each warp's scan total
  __shared__ float s_wa[kWarps][K];
  __shared__ bool s_cont[2];            // continues from previous / into next

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long n = a.n;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const long long tile_end = min(base + kTile, n);
  const long long i0 = base + static_cast<long long>(t) * kItems;

  int key[kItems];
  if (vec_keys && i0 + kItems <= n) {
    const uint64_t first = l2_policy_evict_first();
    const int4 p = load_stream(a.owner + i0, first);
    const int4 q = load_stream(a.owner + i0 + 4, first);
    key[0] = p.x; key[1] = p.y; key[2] = p.z; key[3] = p.w;
    key[4] = q.x; key[5] = q.y; key[6] = q.z; key[7] = q.w;
  } else {
    // past R: an owner of its own, unequal to the last row's and outside
    // [0, V), so those rows form a run that is never written
    const int last = __ldg(a.owner + n - 1);
    const int beyond = last == -1 ? -2 : -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      key[j] = i0 + j < n ? __ldg(a.owner + i0 + j) : beyond;
    }
  }
  s_first[t] = key[0];
  s_last[t] = key[kItems - 1];
  if (t == 0) {
    s_cont[0] = base > 0 && __ldg(a.owner + base - 1) == key[0];
    s_cont[1] = tile_end < n &&
                __ldg(a.owner + tile_end) == __ldg(a.owner + tile_end - 1);
  }

  // the rows' sums: K = 1 at width 8 all 8 rows in flight, else a row at
  // a time
  float v1[kItems];
  unsigned any1 = 0u;
  if constexpr (K == 1) {
    if (w8) {
      int ids[kItems][8];
      ids8(nbr, i0, n, ids);
      sums8<GW>(ids, wgt, bits, msg, i0, n, mask, v1, any1);
    }
  }
  auto row = [&](int j, float (&x)[K], unsigned& live) {
    if constexpr (K == 1) {
      if (w8) {
        x[0] = v1[j];
        live = (any1 >> j) & 1u;
        return;
      }
    }
#pragma unroll
    for (int l = 0; l < K; ++l) x[l] = 0.f;
    live = 0u;
    if (i0 + j < n) {
      lanes_row<float, GW, kAdd, K>(nbr, wgt, bits, msg, i0 + j, width,
                                    mask, w8, x, live);
    }
  };
  __syncthreads();
  const bool cont_prev = s_cont[0];
  const bool cont_next = s_cont[1];
  const long long last_i = tile_end - 1;

  // this thread's runs: interior ones (a head on both sides) are finished
  // now; the first run (up to the first head) and the last (from the last
  // head) stay open.  Each run's got stores go out as it ends.
  bool head_in = false;          // a run head at positions 1..7
  int first_end = kItems - 1;    // position of the first run's last row
  float first_agg[K], acc[K];
  unsigned run_live;
  row(0, acc, run_live);
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    float x[K];
    unsigned live;
    row(j, x, live);
    if (key[j] != key[j - 1]) {
      mark_got<K>(a.got, a.map, a.k, key[j - 1], a.V, run_live);
      if (!head_in) {
#pragma unroll
        for (int l = 0; l < K; ++l) first_agg[l] = acc[l];
        first_end = j - 1;
        head_in = true;
      } else {
        // starts after this thread's first row, so it is not the tile's
        // first run; it is the tile's last only in the last tile
        finish_run<K>(a, key[j - 1], acc, false, i0 + j - 1 == last_i,
                      cont_prev, cont_next, tile);
      }
#pragma unroll
      for (int l = 0; l < K; ++l) acc[l] = x[l];
      run_live = live;
    } else {
#pragma unroll
      for (int l = 0; l < K; ++l) acc[l] = add_(acc[l], x[l]);
      run_live |= live;
    }
  }
  mark_got<K>(a.got, a.map, a.k, key[kItems - 1], a.V, run_live);
  if (!head_in) {
#pragma unroll
    for (int l = 0; l < K; ++l) first_agg[l] = acc[l];
  }
  const bool head0 = t > 0 && key[0] != s_last[t - 1];   // head at row 0

  // block-wide exclusive segmented scan of (head seen, last run's partials)
  bool f = head_in || head0;
  float p[K];
#pragma unroll
  for (int l = 0; l < K; ++l) p[l] = acc[l];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool fo = __shfl_up_sync(~0u, f, o);
    float po[K];
#pragma unroll
    for (int l = 0; l < K; ++l) po[l] = __shfl_up_sync(~0u, p[l], o);
    if (lane >= o) scan_op<K>(fo, po, f, p);
  }
  if (lane == 31) {
    s_wf[warp] = f;
#pragma unroll
    for (int l = 0; l < K; ++l) s_wa[warp][l] = p[l];
  }
  __syncthreads();
  bool pf = false;
  float pa[K];
#pragma unroll
  for (int l = 0; l < K; ++l) pa[l] = 0.f;
  if (warp > 0) {
    pf = s_wf[0];
#pragma unroll
    for (int l = 0; l < K; ++l) pa[l] = s_wa[0][l];
    for (int w = 1; w < warp; ++w) {
      bool wf = s_wf[w];
      float wa[K];
#pragma unroll
      for (int l = 0; l < K; ++l) wa[l] = s_wa[w][l];
      scan_op<K>(pf, pa, wf, wa);
      pf = wf;
#pragma unroll
      for (int l = 0; l < K; ++l) pa[l] = wa[l];
    }
    scan_op<K>(pf, pa, f, p);           // inclusive through this thread
  }
  bool ef = __shfl_up_sync(~0u, f, 1);
  float ea[K];
#pragma unroll
  for (int l = 0; l < K; ++l) ea[l] = __shfl_up_sync(~0u, p[l], 1);
  if (lane == 0) {
    ef = pf;
#pragma unroll
    for (int l = 0; l < K; ++l) ea[l] = pa[l];
  }
  // ef: a head lies between the tile's start and this thread; ea: the
  // partials of the run open at the end of thread t - 1

  const bool carried = t > 0 && !head0;           // first run comes in
  const bool first_starts_tile = t == 0 || (carried && !ef);
  float first_full[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    first_full[l] = carried ? add_(ea[l], first_agg[l]) : first_agg[l];
  }
  // does the run open at row 7 end here?
  const bool ends7 = t == kThreads - 1 || s_first[t + 1] != key[kItems - 1];
  if (i0 < n) {
    if (head_in) {
      finish_run<K>(a, key[0], first_full, first_starts_tile,
                    i0 + first_end == last_i, cont_prev, cont_next, tile);
      if (ends7) {
        finish_run<K>(a, key[kItems - 1], acc, false,
                      i0 + kItems - 1 == last_i, cont_prev, cont_next, tile);
      }
    } else if (ends7) {
      finish_run<K>(a, key[0], first_full, first_starts_tile,
                    i0 + kItems - 1 == last_i, cont_prev, cont_next, tile);
    }
  }
}

// One thread a tile and lane (blockIdx.y): a tile whose last run goes on
// into the next tile, and did not itself come from the previous one,
// folds that run's carries in tile order (segment_sum.cu's fold) and adds
// the total into the run's owner's running entry.
__global__ void stream_fold_carry_kernel(FoldArgs a) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const int l = blockIdx.y;
  const long long tiles = a.tiles;
  if (b >= tiles) return;
  const int fb = a.flags[b];
  if (!(fb & kContNext)) return;
  if ((fb & kSingle) && (fb & kContPrev)) return;   // inside a chain
  const int key = __ldg(a.owner + (b + 1) * kTile);  // the run's owner
  if (key < 0 || key >= a.V) return;
  const float* cf = a.carry_first + l * tiles;
  float acc = a.carry_last[l * tiles + b];
  long long j = b + 1;
  for (bool open = true; open && j < tiles; j += kFoldBatch) {
    int fl[kFoldBatch];
    float c[kFoldBatch];
#pragma unroll
    for (int m = 0; m < kFoldBatch; ++m) {
      if (j + m < tiles) {
        fl[m] = a.flags[j + m];
        c[m] = cf[j + m];
      }
    }
#pragma unroll
    for (int m = 0; m < kFoldBatch; ++m) {
      if (!open || j + m >= tiles) break;
      acc = add_(acc, c[m]);
      open = (fl[m] & kSingle) && (fl[m] & kContNext);   // j + m goes on
    }
  }
  if (__float_as_uint(acc) != 0u) {
    float* at = a.red + a.map.row[l] * a.V + key;
    *at = add_(*at, acc);
  }
}

struct Launch {
  bool mask;                // mask_inactive
  const void* nbr;
  const void* wgt;
  const void* owner;
  LaneMap map;
  int k;
  const void* bits;         // the pre-pass's K-bit frontier words, or null
  const void* msg;          // its (V, K) vertex-major messages
  long long V;
  void* red;
  void* got;
  void* carries;            // (2 k + 1) x tiles words of scratch
  long long tiles;
  long long rows;
  int width;
  cudaStream_t stream;
};

template <int GW, int K>
cudaError_t launch(const Launch& L) {
  if (L.rows == 0) return cudaSuccess;
  float* carries = static_cast<float*>(L.carries);
  const FoldArgs a{static_cast<const int*>(L.owner), L.map,
                   static_cast<float*>(L.red), static_cast<uint8_t*>(L.got),
                   carries, carries + L.k * L.tiles,
                   reinterpret_cast<int*>(carries + 2 * L.k * L.tiles),
                   L.rows, L.V, L.tiles, L.k};
  const bool w8 = L.width == 8 &&
                  reinterpret_cast<uintptr_t>(L.nbr) % 16 == 0 &&
                  (!weighted(GW) ||
                   reinterpret_cast<uintptr_t>(L.wgt) % 16 == 0);
  const bool vec_keys = reinterpret_cast<uintptr_t>(L.owner) % 16 == 0;
  stream_fold_tile_kernel<GW, K><<<L.tiles, kThreads, 0, L.stream>>>(
      static_cast<const int*>(L.nbr), static_cast<const float*>(L.wgt),
      static_cast<const unsigned*>(L.bits),
      static_cast<const float*>(L.msg), a, L.width, L.mask, w8, vec_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || L.tiles == 1) return err;
  const dim3 grid(static_cast<unsigned>((L.tiles + 255) / 256), L.k);
  stream_fold_carry_kernel<<<grid, 256, 0, L.stream>>>(a);
  return cudaGetLastError();
}

template <int GW>
cudaError_t by_k(const Launch& L, int K) {
  switch (K) {
    case 1: return launch<GW, 1>(L);
    case 4: return launch<GW, 4>(L);
    case 8: return launch<GW, 8>(L);
    case 32: return launch<GW, 32>(L);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes: float32 values.  The launch folds the
// k rows listed in `lanes` (host memory, k ints in [0, lane_rows), 1 <= k
// <= K; copied into the launch's parameters) of the (lane_rows, V) running
// tables `red` (float32) and `got` (bytes, or null).  `bits` (with
// mask_inactive) and `msg` are lanes_prepare's tables for these lanes at
// width K (lanes.cuh).  The weighted gathers (add_w, mul_w) apply a slot's
// weight; the others read the pre-pass's message as it is.  `carries` is
// scratch of (2 k + 1) x tiles 4-byte words, tiles = ceil(rows / 2048);
// too few is refused.  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int stream_fold_launch(
    int device, int gather, int mask_inactive, int K, const void* nbr,
    const void* wgt, const void* owner, const int* lanes, int k,
    long long lane_rows, const void* bits, const void* msg, long long V,
    void* red, void* got, void* carries, long long tiles, long long rows,
    int width, void* stream) {
  using namespace repro_torch;
  LaneMap map;
  if (owner == nullptr || msg == nullptr || tiles * kTile < rows ||
      (mask_inactive && bits == nullptr) ||
      !make_lane_map(lanes, k, K, lane_rows, &map)) {
    return cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Launch L{mask_inactive != 0, nbr, wgt, owner, map, k, bits, msg, V,
                 red, got, carries, tiles, rows, width,
                 static_cast<cudaStream_t>(stream)};
  switch (gather) {
    case kCopy:
    case kPlusOne:
    case kDivDeg: return by_k<kCopy>(L, K);
    case kAddW: return by_k<kAddW>(L, K);
    case kMulW: return by_k<kMulW>(L, K);
    default: return cudaErrorInvalidValue;
  }
}
