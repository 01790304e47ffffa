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
//   nll_fwd_kernel       replaces _nll_fwd_kernel (log-softmax + NLL forward)
//   nll_bwd_kernel       replaces _nll_bwd_kernel (its backward)
//   sgd_momentum_kernel  replaces _sgd_kernel     (fused SGD-momentum update)
//
// All three move a few kilobytes per launch on the main path (a [64, 10] logit block; CNN
// leaves of 10 to 16,000 floats), so on this card they are bound by launch latency first
// and by memory bandwidth second; none does enough arithmetic per byte to approach the
// compute bound. The designs therefore read each input once and write each output once,
// keep every intermediate in registers, and need no second pass or scratch buffer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                      // one warp per row
constexpr int kRowThreads = kRowsPerBlock * kWarp;    // 256 threads per block
constexpr int kSgdThreads = 256;
constexpr int kSgdMaxBlocks = 132 * 16;               // 16 blocks per SM on an H100

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

// Replaces ops/pallas_kernels.py::_sgd_kernel.
// v <- momentum * v + g; p <- p - lr * v, elementwise over one parameter leaf.
// The TPU kernel tiles the flattened leaf into [1024, 128] VMEM blocks and writes new p and
// v arrays. Here a grid-stride loop reads p, v and g once and writes p and v once, IN PLACE:
// that saves allocating two new tensors per leaf per step, and the caller owns the buffers.
// __fmul_rn keeps nvcc from contracting the products into FMAs, so every element rounds
// exactly as the plain PyTorch version (two roundings per line) does.
__global__ void sgd_momentum_kernel(float* __restrict__ p, float* __restrict__ v,
                                    const float* __restrict__ g, int64_t n, float lr,
                                    float momentum) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float vi = __fmul_rn(momentum, v[i]) + g[i];
    v[i] = vi;
    p[i] = p[i] - __fmul_rn(lr, vi);
  }
}

int row_blocks(int rows) { return (rows + kRowsPerBlock - 1) / kRowsPerBlock; }

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

int sgd_momentum_f32(float* p, float* v, const float* g, int64_t n, float lr, float momentum,
                     cudaStream_t stream) {
  if (n > 0) {
    int64_t blocks = (n + kSgdThreads - 1) / kSgdThreads;
    if (blocks > kSgdMaxBlocks) blocks = kSgdMaxBlocks;
    sgd_momentum_kernel<<<static_cast<int>(blocks), kSgdThreads, 0, stream>>>(p, v, g, n, lr,
                                                                            momentum);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
