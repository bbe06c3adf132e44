// One-query flash-decode GQA attention over a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_gqa.py::_kernel
// (dispatched by decode_gqa).  Inputs: q (B, K, G, h) contiguous; the k
// and v caches (B, S, K, h), read in place through their strides (unit
// stride over h); pos (B, S) int32 cached positions (-1 = empty, unit
// stride over S); length (B,) int32.  q and the caches are both float32
// or both bfloat16; h is a multiple of 8 up to 256.  Output: (B, K, G, h)
// in q's dtype,
//
//   out[b, k, g] = sum_s softmax_s(cap(scale * q[b, k, g] . k[b, s, k])) v[b, s, k]
//
// where cap(x) = softcap * tanhf(x / softcap) when softcap != 0 (grok's
// attention logit soft-cap, applied before the mask and the running max,
// as repro/models/layers.py::_attn_core does) and x otherwise,
// over the slots s < min(length[b], S) with pos[b, s] >= 0, in float32
// with an online (running max m, sum l, accumulator acc) softmax, and
// acc / max(l, 1e-38) cast to the output dtype.  A masked slot takes no
// part, even one holding NaN or inf.  A row with no valid slot gives
// zeros (the plain version gives NaN; the decode path never makes such a
// row, since it writes the current token first).  The plain version is
// repro_torch/kernels/ref.py::decode_gqa_ref.
//
// What bounds it on an H100: bytes.  The function must read the valid
// slots' k and v rows once (2 * h * elem bytes a slot and kv head), q and
// pos, and write the output: at the served qwen3-8b decode step (8 slots,
// K = 8, h = 128, bf16, ~1,100 valid slots a row) about 36 MB a layer,
// ~11 us at 3.35 TB/s; one 32,768-slot row moves 134 MB, ~40 us.  Its
// products (4 G h flops a slot, G <= 8 query heads a kv head) are two
// orders of magnitude under the tensor cores' rate, so wgmma, whose
// 64-row tiles would be 7/8 padding at G = 8, buys nothing here.
//
// Design (split-sequence flash-decoding on tensor cores):
// - The grid is (B K ceil(G/8)) rows x `splits`, chosen on the host from
//   the row count, S and the SM count so that it fills the blocks the card
//   holds at once, two an SM, in one wave (4 splits at the served shape,
//   33 for one long row; a fifth split at the served shape would start a
//   partial second wave that costs as much as the first); length is
//   never read on the host.  Each block reads length[b] itself and takes
//   its equal, tile-aligned share of [0, n); an empty share writes the
//   neutral partial (m = -inf, l = 0, acc = 0).
// - A tile is 16 slots per warp (4 warps, 64 slots, for bf16 at h <= 256
//   and float32 at h <= 128).  Each warp owns a 16-slot quarter of every
//   tile of the block's share and runs its own 3-stage cp.async ring of
//   k rows, v rows and positions, so warps never wait on each other
//   until the block's end; its 16-byte copies of rows padded by 16 bytes
//   keep ldmatrix free of bank conflicts.
// - bf16 products run on tensor cores, mma.sync.m16n8k16 with ldmatrix
//   fragments: the scores as S^T = K_tile Q^T (M = 16 slots, N = 8 query
//   heads, G padded with zero rows, h / 16 k-steps, Q's fragments held in
//   registers), then acc^T = V^T P^T (M = 16 of h, ldmatrix.trans on the
//   v tile; N = 8; K = 16 slots).  Flash attention rounds p to bf16 for
//   the product; here p goes in as two bf16 terms (hi and the rest), two
//   mma a fragment of v, so the product keeps ~16 bits of p: one rounding
//   put the output's error at the edge of the bf16 tolerance the kernel
//   is held to, and the second mma is free in a kernel bound by bytes.
//   m, l and acc stay float32.  Each tile is read from shared memory
//   once.  The C fragments of both products give a thread the same two
//   query heads, so the rescale by alpha needs no shuffle.  The float32
//   variant (checked, never served) keeps the same fragment layout with
//   CUDA-core dot products.
// - A masked slot's score is selected to -inf and its v row zeroed in
//   shared memory, so a NaN there reaches acc through neither product.
// - The block merges its warps' partials in shared memory; with one split
//   it writes the output, else (m, l, acc) to float32 scratch that a
//   second small kernel merges, acc = sum e^{m_i - M} acc_i /
//   sum e^{m_i - M} l_i, a split with m_i = -inf adding 0.
// - The soft-cap is a template flag: softcap = 0 instantiates the kernel
//   without it, so the uncapped path is the one it was.  tanhf, not
//   tanh.approx.f32, whose ~2^-11 relative error would not hold the
//   float32 check (rtol 1e-4, atol 1e-5).
// - The host sets the shared-memory attribute once per instantiation,
//   device and size, and switches device only when the current one is
//   not the stream's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kSlots = 16;     // slots a warp takes from each tile (mma M)
constexpr int kGroup = 8;      // query heads a block takes (mma N)
constexpr int kStages = 3;     // cp.async ring depth of each warp
constexpr int kPRow = 24;      // p tile row (16 slots + pad), elements
constexpr int kMaxDevices = 64;
constexpr int kCombineThreads = 128;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout shared by both variants (that of the m16n8 C tile):
// lane l holds rows r0 = l / 4 and r0 + 8, columns c0 = 2 (l % 4) and
// c0 + 1, as c[2 i + j] = C[r0 + 8 i][c0 + j].  Scores: rows are slots,
// columns query heads.  acc[mt]: rows are h indices mt * 16 + r0 (+ 8),
// columns query heads.
template <typename T, int kMT>
struct Tile;

template <int kMT>
struct Tile<__nv_bfloat16, kMT> {
  using T = __nv_bfloat16;
  uint32_t qf[kMT][2];   // Q^T's B fragments, one per k-step of 16

  __device__ __forceinline__ void load_q(const T* qs, int row, int nk,
                                         int lane) {
#pragma unroll
    for (int kk = 0; kk < kMT; ++kk) {
      if (kk < nk) {
        ldmatrix_x2(qf[kk], qs + (lane & 7) * row + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      }
    }
  }
  // sc = K_tile Q^T for this warp's 16 slots
  __device__ __forceinline__ void scores(const T* kt, const T* qs, int row,
                                         int nk, int h, int lane,
                                         float* sc) const {
    const int mat = lane >> 3;
    const T* base = kt + ((lane & 7) + (mat & 1) * 8) * row + (mat >> 1) * 8;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kMT; ++kk) {
      if (kk < nk) {
        uint32_t a[4];
        ldmatrix_x4(a, base + kk * 16);
        if (kk & 1) {                    // two independent chains
          mma_bf16(c1, a, qf[kk]);
        } else {
          mma_bf16(c0, a, qf[kk]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = c0[i] + c1[i];
  }
  // p as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi): their sum
  // keeps ~16 bits of p, where one bf16 rounding of p (8 bits) would put
  // the output's error at the bf16 tolerance's edge
  __device__ __forceinline__ static void store_p(T* ps, int i, float p) {
    const T hi = __float2bfloat16_rn(p);
    ps[i] = hi;
    ps[kGroup * kPRow + i] = __float2bfloat16_rn(p - __bfloat162float(hi));
  }
  // acc += V^T (P_hi + P_lo)^T for this warp's 16 slots
  __device__ __forceinline__ void pv(const T* vt, const T* ps, int row,
                                     int nk, int lane,
                                     float (*acc)[4]) const {
    uint32_t pf[4];                      // hi: pf[0..1], lo: pf[2..3]
    ldmatrix_x4(pf, ps + (lane >> 4) * kGroup * kPRow + (lane & 7) * kPRow +
                        ((lane >> 3) & 1) * 8);
    const int mat = lane >> 3;
    const T* base = vt + ((lane & 7) + (mat >> 1) * 8) * row + (mat & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt < nk) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, base + mt * 16);
        mma_bf16(acc[mt], a, pf);
        mma_bf16(acc[mt], a, pf + 2);
      }
    }
  }
};

template <int kMT>
struct Tile<float, kMT> {
  using T = float;
  __device__ __forceinline__ void load_q(const T*, int, int, int) {}
  __device__ __forceinline__ static void store_p(T* ps, int i, float p) {
    ps[i] = p;
  }
  __device__ __forceinline__ void scores(const T* kt, const T* qs, int row,
                                         int, int h, int lane,
                                         float* sc) const {
    const int r0 = lane >> 2, c0 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* kr = kt + (r0 + 8 * i) * row;
        const float* qr = qs + (c0 + j) * row;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int d = 0; d < h; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
          a0 = fmaf(k4.x, q4.x, a0);
          a1 = fmaf(k4.y, q4.y, a1);
          a2 = fmaf(k4.z, q4.z, a2);
          a3 = fmaf(k4.w, q4.w, a3);
        }
        sc[2 * i + j] = (a0 + a1) + (a2 + a3);
      }
    }
  }
  __device__ __forceinline__ void pv(const T* vt, const T* ps, int row,
                                     int nk, int lane,
                                     float (*acc)[4]) const {
    const int r0 = lane >> 2, c0 = (lane & 3) * 2;
    for (int s = 0; s < kSlots; ++s) {
      const float p0 = ps[c0 * kPRow + s], p1 = ps[(c0 + 1) * kPRow + s];
      const float* vr = vt + s * row + r0;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < nk) {
          const float v0 = vr[mt * 16], v1 = vr[mt * 16 + 8];
          acc[mt][0] = fmaf(p0, v0, acc[mt][0]);
          acc[mt][1] = fmaf(p1, v0, acc[mt][1]);
          acc[mt][2] = fmaf(p0, v1, acc[mt][2]);
          acc[mt][3] = fmaf(p1, v1, acc[mt][3]);
        }
      }
    }
  }
};

// Merge of (m, l, acc) partials; a partial with m = -inf adds nothing.
struct Merge {
  float m = -INFINITY, l = 0.f, a = 0.f;
  __device__ __forceinline__ void add_max(float mi) { m = fmaxf(m, mi); }
  __device__ __forceinline__ void add(float mi, float li, float ai) {
    if (mi != -INFINITY) {          // so m = -inf never gives exp(NaN)
      const float w = expf(mi - m);
      l = fmaf(w, li, l);
      a = fmaf(w, ai, a);
    }
  }
  __device__ __forceinline__ float out() const { return a / fmaxf(l, 1e-38f); }
};

struct Args {
  const void *q, *k, *v;
  long long ksb, kss, ksk, vsb, vss, vsk;
  const int* pos;
  long long psb;
  const int* length;
  void* out;
  float* part;          // nullptr: one split, the block writes the output
  int S, K, G, h, splits;
  float scale, softcap;
};

// A score after the soft-cap (kCap) or as it is.
template <bool kCap>
__device__ __forceinline__ float capped(float s, float softcap) {
  return kCap ? softcap * tanhf(s / softcap) : s;
}

// The float32 partial of one (row, split): m[8], l[8], acc[8][h].
__host__ __device__ __forceinline__ long long part_stride(int h) {
  return 2 * kGroup + static_cast<long long>(kGroup) * h;
}

template <typename T, int kMT, bool kCap>
__global__ void __launch_bounds__(128)
    decode_gqa_split_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(T);           // elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = a.h, hp = (h + 15) & ~15, row = hp + kVec, nk = hp / 16;
  const int gc = (a.G + kGroup - 1) / kGroup;
  const int rid = blockIdx.x, split = blockIdx.y;
  const int c = rid % gc, bk = rid / gc, kh = bk % a.K, b = bk / a.K;
  const int gbase = c * kGroup, Gc = min(kGroup, a.G - gbase);

  // shared memory: q [8][row]; then per warp k and v rings
  // [kStages][16][row], the p tiles [2][8][kPRow] and positions
  // [kStages][16]
  T* qs = reinterpret_cast<T*>(smem);
  const int ring = kStages * kSlots * row;
  const size_t warp_bytes = 2 * (ring + kGroup * kPRow) * sizeof(T) +
                            kStages * kSlots * sizeof(int);
  unsigned char* wbase = smem + kGroup * row * sizeof(T) + warp * warp_bytes;
  T* kw = reinterpret_cast<T*>(wbase);
  T* vw = kw + ring;
  T* ps = vw + ring;
  int* pw = reinterpret_cast<int*>(ps + 2 * kGroup * kPRow);

  // q as [8][hp] with zero rows past Gc and zero columns past h; k's
  // columns past h are zero too, so padded k-steps add nothing
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(bk) * a.G + gbase) * h;
  for (int i = tid; i < kGroup * row; i += blockDim.x) {
    const int g = i / row, d = i - g * row;
    qs[i] = (g < Gc && d < h) ? qb[g * h + d] : from_float<T>(0.f);
  }
  if (h != hp) {
    for (int i = lane; i < kStages * kSlots * (hp - h); i += 32) {
      const int r = i / (hp - h);
      kw[r * row + h + (i - r * (hp - h))] = from_float<T>(0.f);
    }
  }
  __syncthreads();

  const int n = min(max(a.length[b], 0), a.S);
  const int bt = kSlots * nw;                     // slots a tile
  const int ntiles = (n + bt - 1) / bt;
  const int per = (ntiles + a.splits - 1) / a.splits;
  const int ta = min(split * per, ntiles), tb = min(ta + per, ntiles);

  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksk;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsk;
  const int* pb = a.pos + b * a.psb;
  const int vpr = h / kVec;                       // 16-byte copies a row
  // copy i = lane + 32 j of a tile is row i / vpr, vector i % vpr: kept
  // as a row and a vector stepped by 32 / vpr and 32 % vpr, so that no
  // copy divides
  const int r_lane = lane / vpr, v_lane = lane - r_lane * vpr;
  const int r_step = 32 / vpr, v_step = 32 - r_step * vpr;
  auto load = [&](int t, int st) {
    const int s0 = t * bt + warp * kSlots;
    T* kd = kw + st * kSlots * row;
    T* vd = vw + st * kSlots * row;
    for (int r = r_lane, v = v_lane; r < kSlots;) {
      const int cc = v * kVec;
      const long long s = s0 + r;
      if (s < n) {
        cp_async16(kd + r * row + cc, kb + s * a.kss + cc);
        cp_async16(vd + r * row + cc, vb + s * a.vss + cc);
      }
      r += r_step;
      v += v_step;
      if (v >= vpr) {
        v -= vpr;
        ++r;
      }
    }
    if (lane < kSlots && s0 + lane < n) {
      cp_async4(pw + st * kSlots + lane, pb + s0 + lane);
    }
  };

  Tile<T, kMT> tile;
  tile.load_q(qs, row, nk, lane);
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (ta + i < tb) load(ta + i, i);
    cp_async_commit();
  }
  for (int t = ta, it = 0; t < tb; ++t, ++it) {
    if (t + kStages - 1 < tb) {
      load(t + kStages - 1, (it + kStages - 1) % kStages);
    }
    cp_async_commit();                     // possibly empty: uniform wait
    cp_async_wait<kStages - 1>();          // this tile's copies landed
    __syncwarp();
    const int st = it % kStages, s0 = t * bt + warp * kSlots;
    if (s0 < n) {                          // warp-uniform
      const T* kt = kw + st * kSlots * row;
      T* vt = vw + st * kSlots * row;
      const int* pt = pw + st * kSlots;
      // valid slots; an invalid slot's v row becomes zeros
      const bool mine = lane < kSlots && s0 + lane < n && pt[lane] >= 0;
      const unsigned bad = __ballot_sync(~0u, lane < kSlots && !mine);
      if (bad) {
        for (int i = lane; i < kSlots * vpr; i += 32) {
          const int r = i / vpr;
          if ((bad >> r) & 1u) {
            *reinterpret_cast<uint4*>(vt + r * row + (i - r * vpr) * kVec) =
                make_uint4(0u, 0u, 0u, 0u);
          }
        }
        __syncwarp();
      }
      const bool v0 = !((bad >> r0) & 1u), v1 = !((bad >> (r0 + 8)) & 1u);

      float sc[4];
      tile.scores(kt, qs, row, nk, h, lane, sc);
      sc[0] = v0 ? capped<kCap>(sc[0] * a.scale, a.softcap) : -INFINITY;
      sc[1] = v0 ? capped<kCap>(sc[1] * a.scale, a.softcap) : -INFINITY;
      sc[2] = v1 ? capped<kCap>(sc[2] * a.scale, a.softcap) : -INFINITY;
      sc[3] = v1 ? capped<kCap>(sc[3] * a.scale, a.softcap) : -INFINITY;

      // online softmax per query head c0 + j over the warp's 16 slots:
      // the 8 lanes sharing c0 hold them
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(sc[j], sc[2 + j]);
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 16));
        const float m_new = fmaxf(m[j], mx);
        float alpha = 1.f, p0 = 0.f, p1 = 0.f;
        if (m_new != -INFINITY) {
          alpha = expf(m[j] - m_new);
          p0 = expf(sc[j] - m_new);
          p1 = expf(sc[2 + j] - m_new);
        }
        m[j] = m_new;
        l[j] = l[j] * alpha + (p0 + p1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc[mt][j] *= alpha;
          acc[mt][2 + j] *= alpha;
        }
        Tile<T, kMT>::store_p(ps, (c0 + j) * kPRow + r0, p0);
        Tile<T, kMT>::store_p(ps, (c0 + j) * kPRow + r0 + 8, p1);
      }
      __syncwarp();
      tile.pv(vt, ps, row, nk, lane, acc);
    }
    __syncwarp();                          // before the stage is refilled
  }
  cp_async_wait<0>();

  // the warp's partial into its own (now idle) ring as float32:
  // m[8], l[8], acc[8][hp]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(~0u, l[j], 4);
    l[j] += __shfl_xor_sync(~0u, l[j], 8);
    l[j] += __shfl_xor_sync(~0u, l[j], 16);
  }
  __syncwarp();
  float* wp = reinterpret_cast<float*>(wbase);
  if (r0 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wp[c0 + j] = m[j];
      wp[kGroup + c0 + j] = l[j];
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (mt < nk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = mt * 16 + r0 + 8 * (i >> 1), g = c0 + (i & 1);
        wp[2 * kGroup + g * hp + d] = acc[mt][i];
      }
    }
  }
  __syncthreads();

  // the block's partial: merge the warps'
  float* part = a.part ? a.part + (static_cast<long long>(rid) * a.splits +
                                   split) * part_stride(h)
                       : nullptr;
  const unsigned char* warps0 = smem + kGroup * row * sizeof(T);
  for (int o = tid; o < Gc * h; o += blockDim.x) {
    const int g = o / h, d = o - g * h;
    Merge mg;
    for (int w = 0; w < nw; ++w) {
      mg.add_max(reinterpret_cast<const float*>(warps0 + w * warp_bytes)[g]);
    }
    for (int w = 0; w < nw; ++w) {
      const float* src =
          reinterpret_cast<const float*>(warps0 + w * warp_bytes);
      mg.add(src[g], src[kGroup + g], src[2 * kGroup + g * hp + d]);
    }
    if (part == nullptr) {
      static_cast<T*>(a.out)[(static_cast<long long>(bk) * a.G + gbase + g) *
                                 h + d] = from_float<T>(mg.out());
    } else {
      if (d == 0) {
        part[g] = mg.m;
        part[kGroup + g] = mg.l;
      }
      part[2 * kGroup + g * h + d] = mg.a;
    }
  }
}

// Merges the splits' partials of one row (b, k, group of 8 query heads):
// block (row, y) writes outputs [128 y, 128 y + 128) of the row's G h.
// The splits' m and l are read into shared memory at once, and the
// weights e^{m_i - M} and the sums L computed there, so that each
// output's loop over the splits is independent loads and FMAs.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_gqa_combine_kernel(const float* __restrict__ part,
                              T* __restrict__ out, int G, int h, int splits) {
  extern __shared__ float cs[];   // w [splits][8], l [splits][8], L [8]
  float* w = cs;
  float* ls = cs + splits * kGroup;
  float* sum = ls + splits * kGroup;
  const int gc = (G + kGroup - 1) / kGroup;
  const int rid = blockIdx.x, c = rid % gc, bk = rid / gc;
  const int gbase = c * kGroup, Gc = min(kGroup, G - gbase);
  const long long stride = part_stride(h);
  const float* p = part + static_cast<long long>(rid) * splits * stride;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < splits * kGroup; i += blockDim.x) {
    const float* pi = p + (i / kGroup) * stride + i % kGroup;
    w[i] = __ldg(pi);                                         // m_i
    ls[i] = __ldg(pi + kGroup);                               // l_i
  }
  __syncthreads();
  // one warp a query head: M = max m_i, w_i = e^{m_i - M}, L = sum w_i l_i
  for (int g = tid >> 5; g < kGroup; g += blockDim.x >> 5) {
    float m = -INFINITY;
    for (int s = lane; s < splits; s += 32) m = fmaxf(m, w[s * kGroup + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    float l = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float mi = w[s * kGroup + g];  // m_i = -inf adds 0, not NaN
      const float wi = mi == -INFINITY ? 0.f : expf(mi - m);
      w[s * kGroup + g] = wi;
      l = fmaf(wi, ls[s * kGroup + g], l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(~0u, l, o);
    if (lane == 0) sum[g] = fmaxf(l, 1e-38f);
  }
  __syncthreads();
  const int o = blockIdx.y * blockDim.x + tid;
  if (o >= Gc * h) return;
  const int g = o / h, d = o - g * h;
  const float* pa = p + 2 * kGroup + g * h + d;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};     // 16 loads in flight
  int s = 0;
#pragma unroll 4
  for (; s + 3 < splits; s += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = fmaf(w[(s + j) * kGroup + g], __ldg(pa + (s + j) * stride),
                    acc[j]);
    }
  }
  for (; s < splits; ++s) {
    acc[0] = fmaf(w[s * kGroup + g], __ldg(pa + s * stride), acc[0]);
  }
  out[(static_cast<long long>(bk) * G + gbase + g) * h + d] =
      from_float<T>(((acc[0] + acc[1]) + (acc[2] + acc[3])) / sum[g]);
}

template <typename T, int kMT, bool kCap>
cudaError_t launch(const Args& a, int device, int B, int warps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int hp = (a.h + 15) & ~15, row = hp + kVec;
  const size_t warp_bytes =
      2ull * (kStages * kSlots * row + kGroup * kPRow) * sizeof(T) +
      kStages * kSlots * sizeof(int);
  const size_t bytes = kGroup * row * sizeof(T) + warps * warp_bytes;
  // the attribute once per instantiation, device and size
  static size_t attr_bytes[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > attr_bytes[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_gqa_split_kernel<T, kMT, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    attr_bytes[device] = bytes;
  }
  const int gc = (a.G + kGroup - 1) / kGroup;
  const int rows = B * a.K * gc;
  decode_gqa_split_kernel<T, kMT, kCap>
      <<<dim3(rows, a.splits), 32 * warps, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.part == nullptr) return err;
  const size_t cbytes = (2 * a.splits + 1) * kGroup * sizeof(float);
  if (cbytes > 48 * 1024) return cudaErrorInvalidValue;
  decode_gqa_combine_kernel<T>
      <<<dim3(rows, (kGroup * a.h + kCombineThreads - 1) / kCombineThreads),
         kCombineThreads, cbytes, stream>>>(
          a.part, static_cast<T*>(a.out), a.G, a.h, a.splits);
  return cudaGetLastError();
}

template <typename T, bool kCap>
cudaError_t by_width(const Args& a, int device, int B, int warps,
                     cudaStream_t s) {
  return a.h <= 128 ? launch<T, 8, kCap>(a, device, B, warps, s)
                    : launch<T, 16, kCap>(a, device, B, warps, s);
}

template <typename T>
cudaError_t by_cap(const Args& a, int device, int B, int warps,
                   cudaStream_t s) {
  return a.softcap != 0.f ? by_width<T, true>(a, device, B, warps, s)
                          : by_width<T, false>(a, device, B, warps, s);
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  dtype selects float32 (0) or
// bfloat16 (1); strides are in elements; softcap 0 means none.  `warps`
// (1..4) sets the tile (16 slots a warp), `splits` the blocks a row;
// with splits > 1, `part` is float32 scratch of
// B * K * ceil(G / 8) * splits * (16 + 8 h) elements.  Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_gqa_launch(int device, int dtype, int B, int S, int K,
                                 int G, int h, int warps, int splits,
                                 float scale, float softcap, const void* q,
                                 const void* k,
                                 const void* v, long long ksb, long long kss,
                                 long long ksk, long long vsb, long long vss,
                                 long long vsk, const void* pos,
                                 long long psb, const void* length,
                                 void* out, void* part, void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > 4 || splits < 1 || h < 8 || h > 256 || h % 8 ||
      (splits > 1) != (part != nullptr)) {
    return cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  const Args a{q, k, v, ksb, kss, ksk, vsb, vss, vsk,
               static_cast<const int*>(pos), psb,
               static_cast<const int*>(length), out,
               static_cast<float*>(part), S, K, G, h, splits, scale,
               softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_cap<float>(a, device, B, warps, s);
    case 1: return by_cap<__nv_bfloat16>(a, device, B, warps, s);
    default: return cudaErrorInvalidValue;
  }
}
