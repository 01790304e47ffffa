// Hand-written paged-decode attention kernel for Hopper (sm_90a): one query token per slot
// attends over that slot's K/V rows, read through a page table.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes and launched from
// ops/paged_attention.py on PyTorch's current stream. The entry point launches one kernel,
// allocates nothing, does not synchronise, and returns cudaGetLastError() (or the error of
// the shared-memory attribute call) so that the Python wrapper raises on a refused launch.
// No --use_fast_math: expf keeps the card close to the plain PyTorch version.
//
//   paged_attend_kernel  replaces _paged_kernel of the JAX package's ops/paged_attention.py
//
// Layouts (the TPU kernel's): q [B, G, R, D] f32 (query heads grouped by their KV head; the
// wrapper hands over f32), K/V pools [num_pages, page_size, G, D] in f32, bf16, int8 or fp8
// e4m3, optional f32 scale pools [num_pages, page_size, G] (a row's value is code · scale),
// table [B, P_max] int32 of page ids, t [B] int32 positions; out [B, G, R, D] f32. Slot b
// sees position p when p <= t[b] and p < seq_len (and t[b] - p < window when a window is
// set); position p lives at pool[table[b, p / page_size], p % page_size]. Unmapped table
// entries point at the allocator's null page: a valid page whose rows the mask hides.
//
// What bounds it: decode reads every visible K/V row once and does 4·D flops per row and
// query row, so at the serving shapes it is bound by memory — and at the serving engine's
// widths (8 slots, 4 heads of 16, up to 784 positions, f32) by launch latency: the whole
// pool read is ~3 MB, a microsecond of the card's 3.35 TB/s. This first version is plain
// SIMT code (no tensor cores, no TMA) that keeps the gathered view out of device memory:
// one block per (slot, KV head) walks the visible positions in tiles of 64, stages each
// tile's K and V rows in shared memory as f32 (dequantised on the way in), and runs the
// online softmax in f32 — the TPU kernel's m, l, acc discipline — so each row is read from
// device memory once. The TPU kernel's sequential page axis becomes this loop inside the
// block; positions before the window and pages past t are never read.
//
// Work in a block of 128 threads, per tile: the first 64 threads look up their position's
// page and row (and scales); all threads copy the K/V rows into shared memory (neighbouring
// threads on neighbouring elements of a row); the threads form the R·64 scores as D-long
// dot products (K rows at a padded stride D + 1, so the column walk hits distinct banks);
// warp w folds rows w, w + 4, ... of the scores into their (m, l) with shuffles; then the
// threads walk the R·D outputs, thread i owning outputs i, i + 128, ..., whose running sums
// sit in shared memory. So the kernel takes any number R of query rows per KV head, as the
// TPU kernel does; R·D only sizes the shared memory (smem_bytes), up to the card's 227 KB
// a block (R = 16 at D = 128 takes 87 KB).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;   // ops/attention.py MASK_VALUE
constexpr int kThreads = 128;          // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // positions per tile (two per lane in the softmax)
constexpr int kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3;   // dtype codes of the C interface

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

struct Args {
  const float* q;         // [B, G, R, D]
  const void* k;          // [num_pages, ps, G, D]
  const void* v;
  const float* k_scale;   // [num_pages, ps, G], or null
  const float* v_scale;
  const int* table;       // [B, P_max]
  const int* t;           // [B]
  float* out;             // [B, G, R, D]
  int G, R, D, ps, p_max, seq_len, window;
  float scale;
};

// Dynamic shared memory: the tile's row offsets (int64, first for alignment), then f32
// q [R][D], K [kTile][D + 1], V [kTile][D], scores [R][kTile], the row scales
// [2][kTile], the softmax state m, l, corr [3][R] and the output sums [R][D].
size_t smem_bytes(int R, int D) {
  const size_t floats = 2 * static_cast<size_t>(R) * D + kTile * (D + 1) + kTile * D +
                        static_cast<size_t>(R) * kTile + 2 * kTile + 3 * static_cast<size_t>(R);
  return kTile * sizeof(long long) + floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attend_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row = reinterpret_cast<long long*>(smem_raw);       // [kTile] pool row, -1 if masked
  float* qs = reinterpret_cast<float*>(row + kTile);              // [R][D]
  const int R = a.R, D = a.D, LD = D + 1;
  float* ks = qs + R * D;                                         // [kTile][LD]
  float* vs = ks + kTile * LD;                                    // [kTile][D]
  float* sc = vs + kTile * D;                                     // [R][kTile]
  float* ksc = sc + R * kTile;                                    // [kTile]
  float* vsc = ksc + kTile;                                       // [kTile]
  float* m_sh = vsc + kTile;                                      // [R]
  float* l_sh = m_sh + R;
  float* c_sh = l_sh + R;
  float* acc = c_sh + R;                                          // [R][D]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.G, g = blockIdx.x % a.G;
  const int tb = a.t[b];
  const int last = min(tb, a.seq_len - 1);                         // newest visible position
  const int first = a.window > 0 ? max(0, tb - a.window + 1) : 0;
  const int64_t head = (static_cast<int64_t>(b) * a.G + g) * R * D;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int i = tid; i < R * D; i += kThreads) {
    qs[i] = a.q[head + i];
    acc[i] = 0.f;            // output i is thread i % kThreads's, in every tile
  }
  for (int r = tid; r < R; r += kThreads) {
    m_sh[r] = kMaskValue;
    l_sh[r] = 0.f;
  }

  for (int p0 = first; p0 <= last; p0 += kTile) {
    __syncthreads();   // q and the softmax state are written; the last tile's readers are done
    if (tid < kTile) {
      const int pos = p0 + tid;
      long long r = -1;
      float kss = 1.f, vss = 1.f;
      if (pos <= last) {
        const int page = a.table[static_cast<int64_t>(b) * a.p_max + pos / a.ps];
        r = (static_cast<long long>(page) * a.ps + pos % a.ps) * a.G + g;
        if (a.k_scale != nullptr) {
          kss = a.k_scale[r];
          vss = a.v_scale[r];
        }
      }
      row[tid] = r;
      ksc[tid] = kss;
      vsc[tid] = vss;
    }
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const long long r = row[j];
      float kv = 0.f, vv = 0.f;
      if (r >= 0) {
        kv = to_f32(kp[r * D + d]) * ksc[j];
        vv = to_f32(vp[r * D + d]) * vsc[j];
      }
      ks[j * LD + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < R * kTile; i += kThreads) {
      const int r = i / kTile, j = i - r * kTile;
      float s = kMaskValue;
      if (p0 + j <= last) {
        const float* qr = qs + r * D;
        const float* kr = ks + j * LD;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * a.scale;
      }
      sc[i] = s;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kWarps) {   // warp-uniform: the shuffles see 32 lanes
      float* srow = sc + r * kTile;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      float mb = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mb);
      const float e0 = p0 + lane <= last ? expf(s0 - m_new) : 0.f;
      const float e1 = p0 + lane + 32 <= last ? expf(s1 - m_new) : 0.f;
      float lb = e0 + e1;
      for (int o = 16; o > 0; o >>= 1) lb += __shfl_xor_sync(0xffffffffu, lb, o);
      srow[lane] = e0;
      srow[lane + 32] = e1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + lb;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* prow = sc + r * kTile;
      float sum = 0.f;
      for (int j = 0; j < kTile; ++j) sum = fmaf(prow[j], vs[j * D + d], sum);
      acc[i] = acc[i] * c_sh[r] + sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const float l = l_sh[i / D];
    a.out[head + i] = acc[i] / (l == 0.f ? 1.f : l);   // a slot with no visible row: 0
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.R, a.D);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  paged_attend_kernel<T><<<B * a.G, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: contiguous f32 [B, G, R, D]; k, v: contiguous [num_pages, ps, G, D] pools of dtype
// code `dtype`; k_scale, v_scale: contiguous f32 [num_pages, ps, G] or both null; table:
// contiguous int32 [B, P_max]; t: int32 [B]; out: contiguous f32 [B, G, R, D]. Any R;
// 1 <= seq_len <= P_max·page_size and B >= 1 (the wrapper checks them); an R·D whose
// shared memory (smem_bytes) the card cannot give a block returns the attribute's error.
int paged_attend(int dtype, const float* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale, const int* table, const int* t,
                 float* out, int B, int G, int R, int D, int ps, int p_max, int seq_len,
                 int window, float scale, cudaStream_t stream) {
  const Args a{q, k, v, k_scale, v_scale, table, t, out, G, R, D, ps, p_max, seq_len, window,
               scale};
  switch (dtype) {
    case kF32: return launch<float>(a, B, stream);
    case kBF16: return launch<__nv_bfloat16>(a, B, stream);
    case kI8: return launch<int8_t>(a, B, stream);
    case kFP8: return launch<__nv_fp8_e4m3>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
