// One-query flash-decode GQA attention over a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_gqa.py::_kernel
// (dispatched by decode_gqa).  Inputs: q (B, K, G, h) contiguous; the k
// and v caches (B, S, K, h), read in place through their strides (unit
// stride over h); pos (B, S) int32 cached positions (-1 = empty, unit
// stride over S); length (B,) int32.  q and the caches are both float32
// or both bfloat16; h is a multiple of 8 up to 256 and G * h <= 4096.
// Output: (B, K, G, h) in q's dtype,
//
//   out[b, k, g] = sum_s softmax_s(scale * q[b, k, g] . k[b, s, k]) v[b, s, k]
//
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
// K = 8, h = 128, bf16, ~1,200 valid slots a row) about 40 MB a layer,
// ~12 us at 3.35 TB/s.  Its products (4 G h flops a slot) are far below
// the card's rate.
//
// Design (simple first): one block of 256 threads per (b, k), holding the
// G queries of that kv head in shared memory as float32.  The block walks
// the slots up to length[b] in tiles of 64 (32 when h > 128): each tile's
// k and v rows are copied into shared memory with cp.async, 16 bytes a
// copy, double-buffered so that the next tile's copy is in flight while
// this tile is computed; the next tile's positions are read into
// registers at the same time.  Per tile: masked slots' v rows are zeroed
// in shared memory; one thread per (g, slot) score (rows padded by 16
// bytes so that the 16-byte reads of 8 neighbouring threads hit distinct
// banks); one warp per g for the running max and sum; then each thread
// updates up to 16 (g, d) outputs of acc, four slots at a time with four
// independent partial sums, so that no loop waits on one load.  Tiles
// past length[b] are never read.  The TPU version's swap of the caches to
// (B, K, S, h) would be a full copy of the cache every layer and step; the
// strided rows here cost nothing extra, each row being h contiguous
// elements.  B * K blocks (64 at the served shape, 8 for one long
// sequence) leave most of the 132 SMs idle: a split over the sequence
// with a combine pass (flash-decoding), TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 16;          // (g, d) outputs a thread: G h <= 4096

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The 16 bytes at p as floats: 4 float32 or 8 bfloat16.
__device__ __forceinline__ void unpack(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h2[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, long long ksb, long long kss,
                      long long ksk, long long vsb, long long vss,
                      long long vsk, const int* __restrict__ pos,
                      long long psb, const int* __restrict__ length,
                      T* __restrict__ out, int S, int K, int G, int h,
                      int tile, float scale) {
  constexpr int kVec = 16 / sizeof(T);     // elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = h + kVec;                // padded shared row, elements
  T* kbuf = reinterpret_cast<T*>(smem);    // [2][tile][row]
  T* vbuf = kbuf + 2 * tile * row;         // [2][tile][row]
  float* qs = reinterpret_cast<float*>(vbuf + 2 * tile * row);  // [G][h]
  float* ps = qs + G * h;                  // [G][tile] scores, then p
  float* m_s = ps + G * tile;              // [G] running max
  float* l_s = m_s + G;                    // [G] running sum
  float* alpha_s = l_s + G;                // [G] this tile's rescale
  int* valid = reinterpret_cast<int*>(alpha_s + G);  // [tile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int n = min(max(length[b], 0), S);
  const int ntiles = (n + tile - 1) / tile;
  const int gh = G * h;
  const T* kb = kc + b * ksb + kh * ksk;
  const T* vb = vc + b * vsb + kh * vsk;
  const int* pb = pos + b * psb;

  const T* qb = q + (static_cast<long long>(b) * K + kh) * gh;
  for (int i = tid; i < gh; i += kThreads) qs[i] = to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // Copy the rows of slots [t0, t0 + tile) below n into stage `stage`.
  const int vpr = h / kVec;                // 16-byte vectors a row
  auto load_tile = [&](int t0, int stage) {
    T* kd = kbuf + stage * tile * row;
    T* vd = vbuf + stage * tile * row;
    for (int i = tid; i < tile * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * kVec;
      const long long s = t0 + r;
      if (s < n) {
        cp_async16(kd + r * row + c, kb + s * kss + c);
        cp_async16(vd + r * row + c, vb + s * vss + c);
      }
    }
    cp_async_commit();
  };
  auto load_pos = [&](int t0) {
    return (tid < tile && t0 + tid < n) ? __ldg(pb + t0 + tid) : -1;
  };

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  int pnext = -1;
  if (ntiles > 0) {
    load_tile(0, 0);
    pnext = load_pos(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, t0 = it * tile;
    const int pcur = pnext;
    if (it + 1 < ntiles) {
      load_tile(t0 + tile, stage ^ 1);
      pnext = load_pos(t0 + tile);
    } else {
      cp_async_commit();                   // an empty group: uniform wait
    }
    cp_async_wait_one();                   // this tile's copies landed
    if (tid < tile) valid[tid] = (t0 + tid < n) && (pcur >= 0);
    __syncthreads();

    // a masked slot's v row becomes zeros, so that the PV loop below needs
    // no branch and a NaN there cannot reach acc (p is 0 there too)
    const T* kt = kbuf + stage * tile * row;
    T* vt = vbuf + stage * tile * row;
    for (int i = tid; i < tile * vpr; i += kThreads) {
      const int r = i / vpr;
      if (!valid[r]) {
        *reinterpret_cast<uint4*>(vt + r * row + (i - r * vpr) * kVec) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // scores: one thread per (g, slot); masked slots get -inf unread
    for (int pi = tid; pi < G * tile; pi += kThreads) {
      const int g = pi / tile, r = pi - g * tile;
      float sc = -INFINITY;
      if (valid[r]) {
        const T* kr = kt + r * row;
        const float* qg = qs + g * h;
        float a[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) a[j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < h; c += kVec) {
          float f[kVec], qv[kVec];
          unpack(kr + c, f);
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qg + c + j);
            qv[j] = q4.x; qv[j + 1] = q4.y; qv[j + 2] = q4.z; qv[j + 3] = q4.w;
          }
#pragma unroll
          for (int j = 0; j < kVec; ++j) a[j] = fmaf(qv[j], f[j], a[j]);
        }
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot += a[j];
        sc = dot * scale;
      }
      ps[pi] = sc;
    }
    __syncthreads();

    // running max and sum: one warp per g
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * tile;
      float mx = -INFINITY;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, pg[r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, alpha = 1.f;
      if (m_new == -INFINITY) {            // nothing valid yet
        for (int r = lane; r < tile; r += 32) pg[r] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
        for (int r = lane; r < tile; r += 32) {
          const float p = expf(pg[r] - m_new);
          pg[r] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha[g] + sum over the tile of p[g, r] v[r, d]
    // (p and v are 0 at masked slots); four independent partial sums and
    // four p values a 16-byte read keep the shared-memory loads in flight
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < gh) {
        const int g = o / h, d = o - g * h;
        const float* pg = ps + g * tile;
        const T* vd = vt + d;
        float a0 = acc[i] * alpha_s[g], a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int r = 0; r < tile; r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pg + r);
          a0 = fmaf(p4.x, to_float(vd[r * row]), a0);
          a1 = fmaf(p4.y, to_float(vd[(r + 1) * row]), a1);
          a2 = fmaf(p4.z, to_float(vd[(r + 2) * row]), a2);
          a3 = fmaf(p4.w, to_float(vd[(r + 3) * row]), a3);
        }
        acc[i] = (a0 + a1) + (a2 + a3);
      }
    }
    __syncthreads();                       // before the stage is reused
  }

  T* ob = out + (static_cast<long long>(b) * K + kh) * gh;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < gh) store(ob + o, acc[i] / fmaxf(l_s[o / h], 1e-38f));
  }
}

template <typename T>
cudaError_t launch(int B, int S, int K, int G, int h, float scale,
                   const void* q, const void* k, const void* v, long long ksb,
                   long long kss, long long ksk, long long vsb, long long vss,
                   long long vsk, const void* pos, long long psb,
                   const void* length, void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int tile = h <= 128 ? 64 : 32;
  const size_t bytes = 4ull * tile * (h + kVec) * sizeof(T) +
                       (static_cast<size_t>(G) * h + G * tile + 3 * G +
                        tile) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      decode_gqa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  decode_gqa_kernel<T><<<B * K, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ksb, kss, ksk, vsb, vss, vsk,
      static_cast<const int*>(pos), psb, static_cast<const int*>(length),
      static_cast<T*>(out), S, K, G, h, tile, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point bound with ctypes.  dtype selects float32 (0) or
// bfloat16 (1); strides are in elements.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int decode_gqa_launch(int device, int dtype, int B, int S, int K,
                                 int G, int h, float scale, const void* q,
                                 const void* k, const void* v, long long ksb,
                                 long long kss, long long ksk, long long vsb,
                                 long long vss, long long vsk,
                                 const void* pos, long long psb,
                                 const void* length, void* out,
                                 void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(B, S, K, G, h, scale, q, k, v, ksb, kss, ksk, vsb,
                           vss, vsk, pos, psb, length, out, s);
    case 1:
      return launch<__nv_bfloat16>(B, S, K, G, h, scale, q, k, v, ksb, kss,
                                   ksk, vsb, vss, vsk, pos, psb, length, out,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}
