// Hand-written flash-attention kernels for Hopper (sm_90a): the forward and the two-kernel
// recompute backward.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes and launched from
// ops/flash_attention.py on PyTorch's current stream. Every entry point launches one kernel,
// allocates nothing, does not synchronise, and returns cudaGetLastError() (or the error of
// the shared-memory attribute call) so that the Python wrapper raises on a refused launch.
// No --use_fast_math: expf/logf keep the card close to the plain PyTorch versions.
//
// Three kernels, one per TPU kernel of the JAX package's ops/pallas_attention.py:
//
//   flash_fwd_kernel  replaces _fwd_kernel (online-softmax attention, out + lse)
//   flash_dq_kernel   replaces _dq_kernel  (dq by recompute)
//   flash_dkv_kernel  replaces _dkv_kernel (dk, dv by recompute)
//
// Operands are [B, S, H, D] tensors read through their strides (D contiguous), so the
// q/k/v views that a fused qkv projection hands over need no copy; outputs are contiguous
// [B, S, H, D], and lse and delta are contiguous f32 [B, H, S]. Inputs are float32 or
// bfloat16; every product is taken in f32 (a bf16 x bf16 product is exact in f32) and
// accumulated in f32. p (forward, dk/dv) and ds (dq, dk/dv) are rounded to the input type
// where they enter a product, where the TPU kernels narrow them (pallas_attention.py:541,
// :711, :780, :786), so kernel and plain version round at the same places.
//
// What bounds them: at the trainer's shapes (S = 2048, D = 16 f32; D = 128 bf16) the work
// is 4·B·H·S²·D flops forward and 6 (dq) and 8 (dk/dv) backward against O(B·S·H·D) bytes,
// so all three are bound by arithmetic, not by memory. These first versions run on the
// CUDA cores in f32 (no tensor cores, no TMA): they keep the S x S scores out of device
// memory, walk only the key (or query) tiles that the causal mask and the window leave
// live, and lay the work out as a small SIMT matrix product per tile — each thread owns a
// few rows by four score columns and a few rows by D/16 output columns, so every value
// read from shared memory feeds several FMAs. Tensor-core (mma/wgmma) and TMA versions are
// later work.
//
// Tiling. A block owns one (b, h) and one tile of 64 query rows (forward, dq) or 64 key
// rows (dk/dv) and loops over the tiles of the other side inside the block: the TPU's
// sequential grid axis becomes that loop, and each block writes only its own rows, so no
// sum crosses blocks and no atomics are needed. Operand tiles sit in shared memory as f32
// with a padded row stride (D + 1) so that the column-strided reads of the score product
// fall in distinct banks. At D = 128 a block holds up to ~166 KB of shared memory (dk/dv),
// which needs cudaFuncSetAttribute(MaxDynamicSharedMemorySize); D = 128 also runs 256
// threads so that each thread's accumulators stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;   // ops/attention.py MASK_VALUE
constexpr int kTile = 64;              // query rows and key rows per tile
constexpr int kF32 = 0, kBF16 = 1;     // dtype codes of the C interface

// A [B, S, H, D] tensor read through its element strides; D is contiguous.
struct Operand {
  const void* ptr;
  int64_t sb, ss, sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T's precision, back in f32: the narrowing at a product.
template <typename T> __device__ __forceinline__ float narrow(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ops/attention.py's mask: causal keeps k <= q, the window keeps |q - k| < window.
__device__ __forceinline__ bool visible(int q, int k, int causal, int window) {
  if (causal && q < k) return false;
  if (window > 0 && (q - k >= window || k - q >= window)) return false;
  return true;
}

// Key tiles [lo, hi) that hold a visible key for some row of the query tile at q0.
__device__ __forceinline__ void live_key_tiles(int q0, int S, int causal, int window,
                                               int* lo, int* hi) {
  const int q_last = q0 + kTile - 1;
  int a = 0, b = S / kTile;
  if (causal) b = min(b, q_last / kTile + 1);
  if (window > 0) {
    const int k_first = q0 - window + 1;            // oldest key the tile's rows see
    a = k_first > 0 ? k_first / kTile : 0;
    if (!causal) b = min(b, (q_last + window - 1) / kTile + 1);
  }
  *lo = a;
  *hi = b;
}

// Query tiles [lo, hi) with a row that sees some key of the key tile at k0.
__device__ __forceinline__ void live_query_tiles(int k0, int S, int causal, int window,
                                                 int* lo, int* hi) {
  const int k_last = k0 + kTile - 1;
  int a = 0, b = S / kTile;
  if (causal) a = k0 / kTile;
  if (window > 0) {
    b = min(b, (k_last + window - 1) / kTile + 1);  // youngest query that sees the tile
    if (!causal) {
      const int q_first = k0 - window + 1;
      a = max(a, q_first > 0 ? q_first / kTile : 0);
    }
  }
  *lo = a;
  *hi = b;
}

template <typename T>
__device__ __forceinline__ const T* slice(const Operand& x, int b, int h) {
  return static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh;
}

// Rows [row0, row0 + kTile) of one (b, h) slice into a [kTile][D + 1] f32 tile.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ tile, const T* __restrict__ base,
                                          int64_t row_stride, int row0) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    tile[r * LD + d] = to_f32(base[static_cast<int64_t>(row0 + r) * row_stride + d]);
  }
}

// Shared memory of each kernel, in floats.
template <int D> constexpr int fwd_smem_floats() { return 3 * kTile * (D + 1) + kTile * (kTile + 1); }
template <int D> constexpr int dq_smem_floats() { return 4 * kTile * (D + 1) + kTile * (kTile + 1); }
template <int D> constexpr int dkv_smem_floats() {
  return 4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile;
}

// Replaces ops/pallas_attention.py::_fwd_kernel.
// out[q] = sum_k softmax_k(q·k·scale)[k] v[k] over the visible keys, lse[q] = m + log(l),
// by the online-softmax recurrence over the live key tiles: per tile, the tile's scores,
// m_new = max(m, max_k s), p = exp(s - m_new) (0 where masked), corr = exp(m - m_new),
// acc = acc·corr + p·v, l = l·corr + sum_k p. Masked scores take kMaskValue, as the TPU
// kernel's do, and l == 0 is guarded. Each half-warp owns RPT query rows: it reduces the
// row max and sum with shuffles, so no statistic goes through shared memory.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(Operand q, Operand k, Operand v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, float scale, int causal, int window) {
  constexpr int RPT = kTile * 16 / NT;   // query rows per thread (and per half-warp)
  constexpr int CPT = kTile / 16;        // score columns per thread
  constexpr int DPT = D / 16;            // output columns per thread
  constexpr int LD = D + 1, LP = kTile + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;

  const int lane16 = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bool masked = causal || window > 0;

  load_tile<T, D, NT>(sQ, slice<T>(q, b, h), q.ss, q0);
  const T* kb = slice<T>(k, b, h);
  const T* vb = slice<T>(v, b, h);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  live_key_tiles(q0, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                       // the previous tile's reads are done
    load_tile<T, D, NT>(sK, kb, k.ss, k0);
    load_tile<T, D, NT>(sV, vb, v.ss, k0);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(lane16 + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = sQ[(row0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + row0 + i;
      float mb = kMaskValue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] *= scale;
        if (masked && !visible(qpos, k0 + lane16 + 16 * j, causal, window)) s[i][j] = kMaskValue;
        mb = fmaxf(mb, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mb));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = lane16 + 16 * j;
        float p = expf(s[i][j] - m_new);
        if (masked && !visible(qpos, k0 + col, causal, window)) p = 0.f;
        rs += p;
        sP[(row0 + i) * LP + col] = narrow<T>(p);
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                       // sP is whole

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = sV[kk * LD + lane16 + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = sP[(row0 + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + row0 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[lane16 + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (lane16 == 0) lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[i] + logf(l_safe);
  }
}

// The recomputed score tile of the backward kernels: for this thread's RPT query rows
// (rows of sQ/sDO) and CPT key columns (rows of sK/sV), p = exp(q·k·scale - lse) (0 where
// masked) and ds = p·(dO·v - delta), each rounded to T (the product operands' type).
template <typename T, int D, int RPT, int CPT>
__device__ __forceinline__ void recompute_tile(
    const float* __restrict__ sQ, const float* __restrict__ sDO, const float* __restrict__ sK,
    const float* __restrict__ sV, const float* lse_r, const float* delta_r, int row0,
    int lane16, int q0, int k0, float scale, int causal, int window, float (&p)[RPT][CPT],
    float (&ds)[RPT][CPT]) {
  constexpr int LD = D + 1;
  float dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) p[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float kv[CPT], vv[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = sK[(lane16 + 16 * j) * LD + d];
      vv[j] = sV[(lane16 + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float qv = sQ[(row0 + i) * LD + d];
      const float dov = sDO[(row0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        p[i][j] = fmaf(qv, kv[j], p[i][j]);
        dp[i][j] = fmaf(dov, vv[j], dp[i][j]);
      }
    }
  }
  const bool masked = causal || window > 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const bool vis = !masked || visible(q0 + row0 + i, k0 + lane16 + 16 * j, causal, window);
      const float sc = vis ? p[i][j] * scale : kMaskValue;
      const float pij = vis ? expf(sc - lse_r[i]) : 0.f;
      ds[i][j] = narrow<T>(pij * (dp[i][j] - delta_r[i]));
      p[i][j] = narrow<T>(pij);
    }
  }
}

// Replaces ops/pallas_attention.py::_dq_kernel.
// dq[q] = scale · sum_k ds[q, k] k[k] over the live key tiles; the block owns its query
// tile, so the sum stays in its registers.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S, int H, float scale,
                int causal, int window) {
  constexpr int RPT = kTile * 16 / NT, CPT = kTile / 16, DPT = D / 16;
  constexpr int LD = D + 1, LP = kTile + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;

  const int lane16 = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;

  load_tile<T, D, NT>(sQ, slice<T>(q, b, h), q.ss, q0);
  load_tile<T, D, NT>(sDO, slice<T>(dout, b, h), dout.ss, q0);
  const T* kb = slice<T>(k, b, h);
  const T* vb = slice<T>(v, b, h);
  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    lse_r[i] = lse[stat + q0 + row0 + i];
    delta_r[i] = delta[stat + q0 + row0 + i];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  live_key_tiles(q0, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D, NT>(sK, kb, k.ss, k0);
    load_tile<T, D, NT>(sV, vb, v.ss, k0);
    __syncthreads();
    float p[RPT][CPT], ds[RPT][CPT];
    recompute_tile<T, D, RPT, CPT>(sQ, sDO, sK, sV, lse_r, delta_r, row0, lane16, q0, k0, scale,
                                   causal, window, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sDS[(row0 + i) * LP + lane16 + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = sK[kk * LD + lane16 + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float dsv = sDS[(row0 + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(dsv, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    T* row = dq + ((static_cast<int64_t>(b) * S + q0 + row0 + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) row[lane16 + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

// Replaces ops/pallas_attention.py::_dkv_kernel.
// dv[k] = sum_q p[q, k] dO[q], dk[k] = scale · sum_q ds[q, k] q[q] over the live query
// tiles; the block owns its key tile. The score tile is recomputed with the same thread
// layout as in the dq kernel (rows = queries); p and ds go through shared memory so that
// the transposed products can read them by key row.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
                 int H, float scale, int causal, int window) {
  constexpr int RPT = kTile * 16 / NT, CPT = kTile / 16, DPT = D / 16;
  constexpr int LD = D + 1, LP = kTile + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;
  float* sDS = sP + kTile * LP;
  float* sLse = sDS + kTile * LP;
  float* sDelta = sLse + kTile;

  const int lane16 = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;

  load_tile<T, D, NT>(sK, slice<T>(k, b, h), k.ss, k0);
  load_tile<T, D, NT>(sV, slice<T>(v, b, h), v.ss, k0);
  const T* qb = slice<T>(q, b, h);
  const T* dob = slice<T>(dout, b, h);
  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int qt_lo, qt_hi;
  live_query_tiles(k0, S, causal, window, &qt_lo, &qt_hi);
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D, NT>(sQ, qb, q.ss, q0);
    load_tile<T, D, NT>(sDO, dob, dout.ss, q0);
    if (threadIdx.x < kTile) {
      sLse[threadIdx.x] = lse[stat + q0 + threadIdx.x];
      sDelta[threadIdx.x] = delta[stat + q0 + threadIdx.x];
    }
    __syncthreads();
    float lse_r[RPT], delta_r[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      lse_r[i] = sLse[row0 + i];
      delta_r[i] = sDelta[row0 + i];
    }
    float p[RPT][CPT], ds[RPT][CPT];
    recompute_tile<T, D, RPT, CPT>(sQ, sDO, sK, sV, lse_r, delta_r, row0, lane16, q0, k0, scale,
                                   causal, window, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        sP[(row0 + i) * LP + lane16 + 16 * j] = p[i][j];
        sDS[(row0 + i) * LP + lane16 + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // This thread's rows are now key rows row0 + i, summed over the tile's queries qq.
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float dov[DPT], qv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        dov[c] = sDO[qq * LD + lane16 + 16 * c];
        qv[c] = sQ[qq * LD + lane16 + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pv = sP[qq * LP + row0 + i];
        const float dsv = sDS[qq * LP + row0 + i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          acc_v[i][c] = fmaf(pv, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t off = ((static_cast<int64_t>(b) * S + k0 + row0 + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[off + lane16 + 16 * c] = from_f32<T>(acc_k[i][c] * scale);
      dv[off + lane16 + 16 * c] = from_f32<T>(acc_v[i][c]);
    }
  }
}

template <int D> constexpr int threads() { return D == 128 ? 256 : 128; }

// Opens the kernel's dynamic shared memory past the 48 KB default where it needs more.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Shape {
  int B, S, H;
  float scale;
  int causal, window;
  dim3 grid() const { return dim3(S / kTile, H, B); }
};

template <typename T, int D>
cudaError_t launch_fwd(Operand q, Operand k, Operand v, void* out, float* lse, Shape s,
                       cudaStream_t stream) {
  constexpr int NT = threads<D>();
  const size_t bytes = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, NT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid(), NT, bytes, stream>>>(q, k, v, static_cast<T*>(out), lse, s.S, s.H, s.scale,
                                          s.causal, s.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(Operand q, Operand k, Operand v, Operand dout, const float* lse,
                      const float* delta, void* dq, Shape s, cudaStream_t stream) {
  constexpr int NT = threads<D>();
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dq_kernel<T, D, NT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid(), NT, bytes, stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(dq), s.S,
                                          s.H, s.scale, s.causal, s.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(Operand q, Operand k, Operand v, Operand dout, const float* lse,
                       const float* delta, void* dk, void* dv, Shape s, cudaStream_t stream) {
  constexpr int NT = threads<D>();
  const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dkv_kernel<T, D, NT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid(), NT, bytes, stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(dk),
                                          static_cast<T*>(dv), s.S, s.H, s.scale, s.causal,
                                          s.window);
  return cudaGetLastError();
}

// Calls fn.template run<T, D>() for the run-time dtype code and head width.
template <typename Fn>
cudaError_t dispatch(int dtype, int d, const Fn& fn) {
  const bool bf16 = dtype == kBF16;
  if (!bf16 && dtype != kF32) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return bf16 ? fn.template run<__nv_bfloat16, 16>() : fn.template run<float, 16>();
    case 64: return bf16 ? fn.template run<__nv_bfloat16, 64>() : fn.template run<float, 64>();
    case 128: return bf16 ? fn.template run<__nv_bfloat16, 128>() : fn.template run<float, 128>();
    default: return cudaErrorInvalidValue;
  }
}

Operand operand(const void* ptr, const int64_t* strides) {
  return Operand{ptr, strides[0], strides[1], strides[2]};
}

struct Fwd {
  Operand q, k, v;
  void* out;
  float* lse;
  Shape s;
  cudaStream_t stream;
  template <typename T, int D> cudaError_t run() const {
    return launch_fwd<T, D>(q, k, v, out, lse, s, stream);
  }
};

struct Dq {
  Operand q, k, v, dout;
  const float *lse, *delta;
  void* dq;
  Shape s;
  cudaStream_t stream;
  template <typename T, int D> cudaError_t run() const {
    return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, s, stream);
  }
};

struct Dkv {
  Operand q, k, v, dout;
  const float *lse, *delta;
  void *dk, *dv;
  Shape s;
  cudaStream_t stream;
  template <typename T, int D> cudaError_t run() const {
    return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, s, stream);
  }
};

}  // namespace

extern "C" {

// q, k, v: [B, S, H, D] with element strides (b, s, h) in q_strides etc.; out: contiguous
// [B, S, H, D] of the same dtype; lse: contiguous f32 [B, H, S]. S must be a multiple of
// 64 and D one of 16, 64, 128 (the wrapper checks both).
int flash_fwd(int dtype, const void* q, const int64_t* q_strides, const void* k,
              const int64_t* k_strides, const void* v, const int64_t* v_strides, void* out,
              float* lse, int B, int S, int H, int D, float scale, int causal, int window,
              cudaStream_t stream) {
  const Fwd fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides), out, lse,
               Shape{B, S, H, scale, causal, window}, stream};
  return dispatch(dtype, D, fn);
}

// As flash_fwd, plus dout (strided like q) and the f32 [B, H, S] statistics lse and delta;
// dq is contiguous [B, S, H, D].
int flash_dq(int dtype, const void* q, const int64_t* q_strides, const void* k,
             const int64_t* k_strides, const void* v, const int64_t* v_strides, const void* dout,
             const int64_t* dout_strides, const float* lse, const float* delta, void* dq, int B,
             int S, int H, int D, float scale, int causal, int window, cudaStream_t stream) {
  const Dq fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides),
              operand(dout, dout_strides), lse, delta, dq,
              Shape{B, S, H, scale, causal, window}, stream};
  return dispatch(dtype, D, fn);
}

// As flash_dq, writing dk and dv (contiguous [B, S, H, D]).
int flash_dkv(int dtype, const void* q, const int64_t* q_strides, const void* k,
              const int64_t* k_strides, const void* v, const int64_t* v_strides, const void* dout,
              const int64_t* dout_strides, const float* lse, const float* delta, void* dk,
              void* dv, int B, int S, int H, int D, float scale, int causal, int window,
              cudaStream_t stream) {
  const Dkv fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides),
               operand(dout, dout_strides), lse, delta, dk, dv,
               Shape{B, S, H, scale, causal, window}, stream};
  return dispatch(dtype, D, fn);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
