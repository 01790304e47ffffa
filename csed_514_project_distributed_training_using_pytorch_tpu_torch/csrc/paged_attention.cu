// Hand-written paged-decode attention kernels for Hopper (sm_90a): one query token per slot
// attends over that slot's K/V rows, read through a page table (flash-decoding: each slot's
// positions are split over several blocks, whose partial softmaxes a second pass merges).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes and launched from
// ops/paged_attention.py on PyTorch's current stream. The entry point launches the split
// kernel and, when it splits, the combine kernel; it allocates nothing (the wrapper hands
// over the partials' workspace), does not synchronise, and returns cudaGetLastError() (or
// the error of the shared-memory attribute call) so that the Python wrapper raises on a
// refused launch. No --use_fast_math: expf keeps the card close to the plain PyTorch
// version.
//
//   paged_attend_kernel          replaces _paged_kernel of the JAX package's
//                                ops/paged_attention.py, one chunk of positions a block
//   paged_attend_combine_kernel  merges the chunks' partial softmaxes (the TPU kernel's
//                                sequential page walk carries them in scratch instead)
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
// widths (8 slots, 4 heads of 16, up to 784 positions, f32) by latency: the whole pool read
// is ~3 MB, a microsecond of the card's 3.35 TB/s, while a block that walks one slot's
// positions in series spends tens of microseconds on dependent loads and barriers. What
// the design does about it:
//
// - The work is spread over the card. The grid is (B·G·row blocks, n_split): each (slot,
//   KV head) is cut into n_split chunks of whole 64-position tiles, and each block runs
//   the online softmax — the TPU kernel's m, l, acc discipline, in f32 — over its chunk's
//   visible positions and writes its partial (m, l, acc) to the workspace. A chunk wholly
//   outside the visible range writes l = 0 and returns. paged_attend_combine_kernel then
//   merges the chunks of each output row: m* = max m_i, out = Σ acc_i·e^(m_i − m*) /
//   Σ l_i·e^(m_i − m*) over the chunks with l_i > 0 (zeros where none is). The wrapper
//   chooses n_split from the shapes alone (B, G, R, D, seq_len and the SM count), never
//   from t, so a call makes no device-to-host sync; n_split = 1 when the blocks already
//   fill the card, and then the one block a row writes out itself and nothing is merged.
// - Inside a block, all 128 threads work on every step of a tile. Each copy moves one
//   position's 16 bytes of K and the same of V (4 f32, 8 bf16, 16 int8 or fp8 codes; one
//   element where the pool's rows are not 16-byte multiples), the thread looking up the
//   position's page itself, in a loop unrolled so that several lookups and then several
//   row loads are in flight; the values are dequantised into f32 shared memory on the way
//   in (rows padded to D + 4 floats, 16-byte aligned, so that the float4 reads below fall
//   in distinct banks). Invisible positions read as 0 and are never fetched. The scores
//   take one thread per (position, query row) pair, a float4 dot product over D against q,
//   which is staged pre-scaled as the plain version scales it. Warp w folds rows w,
//   w + 4, ... of the scores into their (m, l) with shuffles. For P·V each thread owns one
//   float4 of the block's outputs (a query row and 4 columns) and a share of the tile's
//   positions, strided over the 128 / (rows·D/4) threads that own the same float4; their
//   sums stay in registers across the chunk and meet once, at its end, in shared memory.
// - A block takes at most rows_per_block query rows (so that rows·D/4 <= 128 float4
//   outputs); a KV head with more query rows is cut into row blocks, each reading the
//   tile's K/V rows again (from L2, at most 32 KB a tile per row block). So the kernel
//   takes any number R of query rows per KV head, as the TPU kernel does.
//
// The arithmetic is f32 FFMA, not the tensor cores: at 4·D flops per K/V row and query row
// the card runs out of bytes and latency long before it runs out of f32 operations.

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
  float* part_acc;        // [n_split][B·G·R][D] unnormalised sums, or null (n_split == 1)
  float2* part_ml;        // [n_split][B·G·R] (m, l)
  int G, R, D, ps, p_max, seq_len, window;
  int rows_per_block, row_blocks, split_tiles;
  float scale;
};

// Dynamic shared memory, in floats: the P·V partials [kThreads] float4, then q [rows][D]
// (times scale), K and V [kTile][D + 4], scores [rows][kTile] and the softmax state m, l,
// corr [3][rows].
size_t smem_bytes(int rows, int D) {
  const size_t floats = 4 * kThreads + static_cast<size_t>(rows) * D + 2 * kTile * (D + 4) +
                        static_cast<size_t>(rows) * kTile + 3 * static_cast<size_t>(rows);
  return floats * sizeof(float);
}

// One block: query rows [r0, r0 + rows) of one (slot b, KV head g), over the visible
// positions of chunk blockIdx.y (tiles [y·split_tiles, (y + 1)·split_tiles)). kVec: the
// pool's rows are read 16 bytes at a time (D·sizeof(T) a multiple of 16, pools aligned).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) paged_attend_kernel(const Args a) {
  constexpr int CH = kVec ? 16 / sizeof(T) : 1;    // pool elements a copy moves
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, LD = D + 4, D4 = D / 4;
  float4* red = reinterpret_cast<float4*>(smem);                  // [kThreads]
  float* qs = smem + 4 * kThreads;                                // [rows][D]
  float* ks = qs + a.rows_per_block * D;                          // [kTile][LD]
  float* vs = ks + kTile * LD;                                    // [kTile][LD]
  float* sc = vs + kTile * LD;                                    // [rows][kTile]
  float* m_sh = sc + a.rows_per_block * kTile;                    // [rows]
  float* l_sh = m_sh + a.rows_per_block;
  float* c_sh = l_sh + a.rows_per_block;

  const int tid = threadIdx.x;
  const int bg = blockIdx.x / a.row_blocks;                       // b·G + g
  const int b = bg / a.G, g = bg % a.G;
  const int r0 = (blockIdx.x % a.row_blocks) * a.rows_per_block;
  const int rows = min(a.rows_per_block, a.R - r0);
  const int64_t total = static_cast<int64_t>(gridDim.x / a.row_blocks) * a.R;   // B·G·R
  const int64_t qrow = static_cast<int64_t>(bg) * a.R + r0;       // the block's first row
  const int split = blockIdx.y;
  const int tb = a.t[b];
  const int first = a.window > 0 ? max(0, tb - a.window + 1) : 0;
  const int c0 = split * a.split_tiles * kTile;                   // the chunk's positions
  const int lo = max(first, c0);
  const int hi = min(min(tb, a.seq_len - 1), c0 + a.split_tiles * kTile - 1);
  if (lo > hi) {                   // nothing of the chunk is visible
    if (a.part_ml != nullptr) {
      for (int r = tid; r < rows; r += kThreads)
        a.part_ml[split * total + qrow + r] = make_float2(kMaskValue, 0.f);
    } else {                       // the slot's one chunk: no visible row, out = 0
      for (int i = tid; i < rows * D; i += kThreads) a.out[qrow * D + i] = 0.f;
    }
    return;
  }

  const float* q = a.q + qrow * D;
  for (int i = tid; i < rows * D; i += kThreads) qs[i] = q[i] * a.scale;
  for (int r = tid; r < rows; r += kThreads) {
    m_sh[r] = kMaskValue;
    l_sh[r] = 0.f;
  }
  // P·V: this thread's float4 of the output (query row pr, columns pc .. pc + 3) over the
  // positions grp, grp + n_grp, ... of each tile
  const int slots = rows * D4, n_grp = kThreads / slots;
  const int slot = tid % slots, grp = tid / slots;
  const int pr = slot / D4, pc = (slot % D4) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int chunks = D / CH;       // copies a row

  for (int p0 = lo / kTile * kTile; p0 <= hi; p0 += kTile) {
    __syncthreads();   // q and the state are written; the previous tile's readers are done
    // a copy moves CH elements of one position's K row and the same of its V row; the
    // unrolled loop keeps several table lookups, then several row loads, in flight
#pragma unroll 4
    for (int e = tid; e < kTile * chunks; e += kThreads) {
      const int j = e / chunks, c = (e % chunks) * CH;
      const int pos = p0 + j;
      float xk[CH], xv[CH];
      if (pos >= lo && pos <= hi) {
        const int page = a.table[static_cast<int64_t>(b) * a.p_max + pos / a.ps];
        const int64_t row = (static_cast<int64_t>(page) * a.ps + pos % a.ps) * a.G + g;
        const float sk = a.k_scale != nullptr ? a.k_scale[row] : 1.f;
        const float sv = a.v_scale != nullptr ? a.v_scale[row] : 1.f;
        if constexpr (kVec) {
          const uint4 rk = *reinterpret_cast<const uint4*>(kp + row * D + c);
          const uint4 rv = *reinterpret_cast<const uint4*>(vp + row * D + c);
          const T* ek = reinterpret_cast<const T*>(&rk);
          const T* ev = reinterpret_cast<const T*>(&rv);
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            xk[u] = to_f32(ek[u]) * sk;
            xv[u] = to_f32(ev[u]) * sv;
          }
        } else {
          xk[0] = to_f32(kp[row * D + c]) * sk;
          xv[0] = to_f32(vp[row * D + c]) * sv;
        }
      } else {
#pragma unroll
        for (int u = 0; u < CH; ++u) xk[u] = xv[u] = 0.f;
      }
      float* dk = ks + j * LD + c;
      float* dv = vs + j * LD + c;
      if constexpr (kVec) {
#pragma unroll
        for (int u = 0; u < CH; u += 4) {
          *reinterpret_cast<float4*>(dk + u) = make_float4(xk[u], xk[u + 1], xk[u + 2], xk[u + 3]);
          *reinterpret_cast<float4*>(dv + u) = make_float4(xv[u], xv[u + 1], xv[u + 2], xv[u + 3]);
        }
      } else {
        dk[0] = xk[0];
        dv[0] = xv[0];
      }
    }
    __syncthreads();
    {   // scores: position j against rows tid / kTile, + 2, ...
      const int j = tid % kTile;
      const bool vis = p0 + j >= lo && p0 + j <= hi;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * LD);
      for (int r = tid / kTile; r < rows; r += kThreads / kTile) {
        float s = kMaskValue;
        if (vis) {
          const float4* qr = reinterpret_cast<const float4*>(qs + r * D);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          for (int c = 0; c < D4; ++c) {
            const float4 kv = kr[c], qv = qr[c];
            d0 = fmaf(qv.x, kv.x, d0);
            d1 = fmaf(qv.y, kv.y, d1);
            d2 = fmaf(qv.z, kv.z, d2);
            d3 = fmaf(qv.w, kv.w, d3);
          }
          s = (d0 + d1) + (d2 + d3);
        }
        sc[r * kTile + j] = s;
      }
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kWarps) {   // warp-uniform: the shuffles see 32 lanes
      float* srow = sc + r * kTile;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      float mb = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mb);
      const bool v0 = p0 + lane >= lo && p0 + lane <= hi;
      const bool v1 = p0 + lane + 32 >= lo && p0 + lane + 32 <= hi;
      const float e0 = v0 ? expf(s0 - m_new) : 0.f;
      const float e1 = v1 ? expf(s1 - m_new) : 0.f;
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
    if (grp < n_grp) {
      const float corr = c_sh[pr];
      const float* prow = sc + pr * kTile;
      acc.x *= corr;
      acc.y *= corr;
      acc.z *= corr;
      acc.w *= corr;
      for (int j = grp; j < kTile; j += n_grp) {
        const float p = prow[j];
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + pc);
        acc.x = fmaf(p, vv.x, acc.x);
        acc.y = fmaf(p, vv.y, acc.y);
        acc.z = fmaf(p, vv.z, acc.z);
        acc.w = fmaf(p, vv.w, acc.w);
      }
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < slots) {               // slot tid, group 0: the sum over the groups
    float4 sum = red[tid];
    for (int i = 1; i < n_grp; ++i) {
      const float4 x = red[i * slots + tid];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int64_t at = (qrow + pr) * D + pc;
    if (a.part_acc != nullptr) {
      *reinterpret_cast<float4*>(a.part_acc + split * total * D + at) = sum;
    } else {       // l >= 1 (the chunk's largest p is 1): see the combine kernel
      const float l = l_sh[pr];
      *reinterpret_cast<float4*>(a.out + at) =
          make_float4(__fdividef(sum.x, l), __fdividef(sum.y, l), __fdividef(sum.z, l),
                      __fdividef(sum.w, l));
    }
  }
  if (a.part_ml != nullptr && tid < rows)
    a.part_ml[split * total + qrow + tid] = make_float2(m_sh[tid], l_sh[tid]);
}

// out[row, c .. c + 3] = Σ acc_i·e^(m_i − m*) / Σ l_i·e^(m_i − m*) over the chunks i with
// l_i > 0, m* = max m_i; 0 where no chunk saw a position. One thread a float4 of out. The
// quotient is __fdividef's: the denominator is 0 or at least 1 (the chunk at m* has
// l >= 1), where it lies within 2 ulp of the IEEE quotient and needs no call to the
// division's slow path (whose saved registers spill).
__global__ void __launch_bounds__(kThreads)
paged_attend_combine_kernel(const float* __restrict__ part_acc,
                            const float2* __restrict__ part_ml, float* __restrict__ out,
                            int64_t total, int D, int n_split) {
  const int D4 = D / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total * D4) return;
  const int64_t row = i / D4;
  const int c = static_cast<int>(i % D4) * 4;
  float m = kMaskValue;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float2 ml = part_ml[s * total + row];
    if (ml.y > 0.f) m = fmaxf(m, ml.x);
  }
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float2 ml = part_ml[s * total + row];
    if (ml.y > 0.f) {
      const float w = expf(ml.x - m);
      const float4 x = *reinterpret_cast<const float4*>(part_acc + (s * total + row) * D + c);
      l = fmaf(ml.y, w, l);
      o.x = fmaf(x.x, w, o.x);
      o.y = fmaf(x.y, w, o.y);
      o.z = fmaf(x.z, w, o.z);
      o.w = fmaf(x.w, w, o.w);
    }
  }
  const float l_safe = l == 0.f ? 1.f : l;
  *reinterpret_cast<float4*>(out + row * D + c) =
      make_float4(__fdividef(o.x, l_safe), __fdividef(o.y, l_safe), __fdividef(o.z, l_safe),
                  __fdividef(o.w, l_safe));
}

template <typename T, bool kVec>
cudaError_t launch_split(const Args& a, int B, int n_split, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.rows_per_block, a.D);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * a.G * a.row_blocks, n_split);
  paged_attend_kernel<T, kVec><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int B, int n_split, cudaStream_t stream) {
  const bool vec = (a.D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const cudaError_t e = vec ? launch_split<T, true>(a, B, n_split, stream)
                            : launch_split<T, false>(a, B, n_split, stream);
  if (e != cudaSuccess || n_split == 1) return e;
  const int64_t total = static_cast<int64_t>(B) * a.G * a.R;
  const int64_t n = total * (a.D / 4);
  paged_attend_combine_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
                                0, stream>>>(a.part_acc, a.part_ml, a.out, total, a.D,
                                             n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: contiguous f32 [B, G, R, D]; k, v: contiguous [num_pages, ps, G, D] pools of dtype
// code `dtype`; k_scale, v_scale: contiguous f32 [num_pages, ps, G] or both null; table:
// contiguous int32 [B, P_max]; t: int32 [B]; out: contiguous f32 [B, G, R, D]. The block
// plan comes from the wrapper: rows_per_block query rows a block (rows_per_block·D <= 512),
// n_split chunks of ceil(ceil(seq_len / 64) / n_split) tiles a slot; workspace: f32
// [n_split·B·G·R·(D + 2)] (the partials), unused (may be null) when n_split == 1. Any R;
// D a multiple of 4, 1 <= seq_len <= P_max·page_size and B >= 1 (the wrapper checks them).
int paged_attend(int dtype, const float* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale, const int* table, const int* t,
                 float* out, float* workspace, int B, int G, int R, int D, int ps, int p_max,
                 int seq_len, int window, int rows_per_block, int n_split, float scale,
                 cudaStream_t stream) {
  if (D % 4 != 0 || rows_per_block < 1 || rows_per_block * D > 4 * kThreads || n_split < 1 ||
      (n_split > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const int tiles = (seq_len + kTile - 1) / kTile;
  const int64_t partials = static_cast<int64_t>(n_split) * B * G * R;
  float* part_acc = n_split > 1 ? workspace : nullptr;
  float2* part_ml = n_split > 1 ? reinterpret_cast<float2*>(workspace + partials * D) : nullptr;
  const Args a{q, k, v, k_scale, v_scale, table, t, out, part_acc, part_ml, G, R, D, ps, p_max,
               seq_len, window, rows_per_block, (R + rows_per_block - 1) / rows_per_block,
               (tiles + n_split - 1) / n_split, scale};
  switch (dtype) {
    case kF32: return launch<float>(a, B, n_split, stream);
    case kBF16: return launch<__nv_bfloat16>(a, B, n_split, stream);
    case kI8: return launch<int8_t>(a, B, n_split, stream);
    case kFP8: return launch<__nv_fp8_e4m3>(a, B, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
