// Hand-written CUDA kernels of the MNIST trainer's training step, for Hopper (sm_90a).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes and launched from
// ops/fused_kernels.py on PyTorch's current stream. Every entry point launches one kernel,
// allocates nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper raises on a refused launch. No --use_fast_math: expf/logf and IEEE
// division keep the card close to the plain PyTorch versions.
//
// Three kernels, one per TPU kernel of the JAX package's ops/pallas_kernels.py:
//
//   nll_fwd_kernel             replaces _nll_fwd_kernel (log-softmax + NLL forward)
//   nll_bwd_kernel             replaces _nll_bwd_kernel (its backward)
//   sgd_momentum_multi_kernel  replaces _sgd_kernel     (fused SGD-momentum update), over up
//                              to kSgdTableLeaves leaves in one launch
//
// All three move a few kilobytes per launch on the main path (a [64, 10] logit block; CNN
// leaves of 10 to 16,000 floats), so on this card they are bound by launch latency first
// and by memory bandwidth second; none does enough arithmetic per byte to approach the
// compute bound. The designs therefore read each input once and write each output once,
// keep every intermediate in registers, and need no second pass or scratch buffer; and the
// step's update goes out as one launch over all its leaves, not one launch a leaf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                      // one warp per row
constexpr int kRowThreads = kRowsPerBlock * kWarp;    // 256 threads per block
constexpr int kSgdThreads = 256;
constexpr int kSgdMaxBlocks = 132 * 16;               // 16 blocks per SM on an H100
constexpr int kSgdTableLeaves = 64;                   // leaves per multi-tensor launch

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Row max and sum of exp(x - max) over one row, spread over the lanes of a warp. Every
// lane returns the warp-wide values.
__device__ __forceinline__ void row_max_sumexp(const float* __restrict__ x, int cols,
                                               int lane, float* m_out, float* s_out) {
  float m = -INFINITY;
  for (int c = lane; c < cols; c += kWarp) m = fmaxf(m, x[c]);
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < cols; c += kWarp) s += expf(x[c] - m);
  *m_out = m;
  *s_out = warp_sum(s);
}

// Replaces ops/pallas_kernels.py::_nll_fwd_kernel.
// nll[row] = -((x[row, label] - max) - log(sum(exp(x[row, :] - max)))).
// The TPU kernel pads each [256, 128] tile with -1e30 and reduces over lanes of the vector
// unit. Here one warp owns one row: lanes stride over the classes, and shuffles reduce the
// max and the sum without shared memory. The row is read from device memory once; the
// second and third passes hit L1. A label outside [0, cols) picks nothing and gives 0, as
// the TPU kernel's where(classes == label, ...) does.
__global__ void nll_fwd_kernel(const float* __restrict__ logits,
                               const int64_t* __restrict__ labels,
                               float* __restrict__ nll, int rows, int cols) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // the whole warp shares the row, so it leaves together
  const float* x = logits + static_cast<int64_t>(row) * cols;
  float m, s;
  row_max_sumexp(x, cols, lane, &m, &s);
  const float lse = logf(s);
  const int64_t label = labels[row];
  float picked = 0.f;
  for (int c = lane; c < cols; c += kWarp)
    if (c == label) picked += (x[c] - m) - lse;
  picked = warp_sum(picked);
  if (lane == 0) nll[row] = -picked;
}

// Replaces ops/pallas_kernels.py::_nll_bwd_kernel.
// dlogits[row, c] = (exp(x - max) / sum - [c == label]) * (ct_scale * ct[row * ct_stride]).
// ct_stride 0 broadcasts one scalar cotangent to every row (reductions mean and sum, with
// ct_scale 1/B and 1), so the wrapper needs no extra launch to expand it; ct_stride 1
// reads one cotangent per row (reduction none). Same one-warp-per-row layout as the
// forward: it recomputes max and sum rather than storing them, which costs less than the
// extra write and read would.
__global__ void nll_bwd_kernel(const float* __restrict__ logits,
                               const int64_t* __restrict__ labels,
                               const float* __restrict__ ct, int64_t ct_stride,
                               float ct_scale, float* __restrict__ dlogits,
                               int rows, int cols) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int64_t offset = static_cast<int64_t>(row) * cols;
  const float* x = logits + offset;
  float m, s;
  row_max_sumexp(x, cols, lane, &m, &s);
  const int64_t label = labels[row];
  const float g = ct_scale * ct[row * ct_stride];
  for (int c = lane; c < cols; c += kWarp) {
    const float softmax = expf(x[c] - m) / s;
    const float onehot = (c == label) ? 1.f : 0.f;
    dlogits[offset + c] = (softmax - onehot) * g;
  }
}

// The leaves of one launch, passed by value as the kernel's argument (2.3 KB, within the
// 4 KB a kernel's parameters may take): each leaf's pointers and size, and the first block
// of each leaf (a prefix sum of the leaves' block counts; first_block[count] is the grid's
// size).
struct SgdTable {
  float* p[kSgdTableLeaves];
  float* v[kSgdTableLeaves];
  const float* g[kSgdTableLeaves];
  int64_t n[kSgdTableLeaves];
  int first_block[kSgdTableLeaves + 1];
  int count;
};

// Replaces ops/pallas_kernels.py::_sgd_kernel.
// v <- momentum * v + g; p <- p - lr * v, elementwise over every leaf of the table.
// The TPU kernel tiles each flattened leaf into [1024, 128] VMEM blocks and writes new p
// and v arrays, one launch a leaf. The CNN's update is 8 leaves of 10 to 16,000 floats, and
// a launch a leaf spends ~25 us of host time for ~1.4 us of device time, so one launch
// takes them all: each block finds its leaf by a binary search of first_block (the table
// lives in the parameter space, read in place through __grid_constant__), then a
// grid-stride loop over the leaf's blocks reads p, v and g once and writes p and v once,
// IN PLACE: that saves allocating two new tensors per leaf per step, and the caller owns
// the buffers. __fmul_rn keeps nvcc from contracting the products into FMAs, so every
// element rounds exactly as the plain PyTorch version (two roundings per line) does.
__global__ void __launch_bounds__(kSgdThreads)
sgd_momentum_multi_kernel(const __grid_constant__ SgdTable table, float lr, float momentum) {
  const int block = static_cast<int>(blockIdx.x);
  int lo = 0, hi = table.count - 1;      // the last leaf whose first block is <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.first_block[mid] <= block) lo = mid; else hi = mid - 1;
  }
  float* __restrict__ p = table.p[lo];
  float* __restrict__ v = table.v[lo];
  const float* __restrict__ g = table.g[lo];
  const int first = table.first_block[lo];
  const int64_t n = table.n[lo];
  const int64_t stride = static_cast<int64_t>(table.first_block[lo + 1] - first) * kSgdThreads;
  for (int64_t i = static_cast<int64_t>(block - first) * kSgdThreads + threadIdx.x; i < n;
       i += stride) {
    const float vi = __fmul_rn(momentum, v[i]) + g[i];
    v[i] = vi;
    p[i] = p[i] - __fmul_rn(lr, vi);
  }
}

int row_blocks(int rows) { return (rows + kRowsPerBlock - 1) / kRowsPerBlock; }

// Blocks of a leaf of n elements: one element a thread, at most kSgdMaxBlocks (the
// grid-stride loop takes the rest).
int sgd_blocks(int64_t n) {
  const int64_t blocks = (n + kSgdThreads - 1) / kSgdThreads;
  return static_cast<int>(blocks < kSgdMaxBlocks ? blocks : kSgdMaxBlocks);
}

}  // namespace

extern "C" {

// The caller makes the stream's device current (the wrapper launches under
// torch.cuda.device); a stream of another device comes back as a launch error.

int nll_fwd_f32(const float* logits, const int64_t* labels, float* nll, int rows, int cols,
                cudaStream_t stream) {
  if (rows > 0)
    nll_fwd_kernel<<<row_blocks(rows), kRowThreads, 0, stream>>>(logits, labels, nll, rows,
                                                                  cols);
  return static_cast<int>(cudaGetLastError());
}

int nll_bwd_f32(const float* logits, const int64_t* labels, const float* ct,
                int64_t ct_stride, float ct_scale, float* dlogits, int rows, int cols,
                cudaStream_t stream) {
  if (rows > 0)
    nll_bwd_kernel<<<row_blocks(rows), kRowThreads, 0, stream>>>(
        logits, labels, ct, ct_stride, ct_scale, dlogits, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// One launch over count <= kSgdTableLeaves leaves: p[i], v[i], g[i] (host arrays of device
// pointers) hold n[i] elements each. Leaves of 0 elements get no block; no leaf, no launch.
int sgd_momentum_multi_f32(float* const* p, float* const* v, const float* const* g,
                           const int64_t* n, int count, float lr, float momentum,
                           cudaStream_t stream) {
  if (count < 0 || count > kSgdTableLeaves) return static_cast<int>(cudaErrorInvalidValue);
  SgdTable table;
  table.count = count;
  table.first_block[0] = 0;
  for (int i = 0; i < count; ++i) {
    table.p[i] = p[i];
    table.v[i] = v[i];
    table.g[i] = g[i];
    table.n[i] = n[i];
    table.first_block[i + 1] = table.first_block[i] + (n[i] > 0 ? sgd_blocks(n[i]) : 0);
  }
  if (table.first_block[count] > 0)
    sgd_momentum_multi_kernel<<<table.first_block[count], kSgdThreads, 0, stream>>>(
        table, lr, momentum);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
