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
// Six kernels for the three TPU kernels of the JAX package's ops/pallas_attention.py, all
// on the tensor cores (mma.sync); each TPU kernel has one route per operand type, chosen by
// the dtype alone:
//
//   flash_fwd_tf32_kernel  replaces _fwd_kernel (online-softmax attention, out + lse), f32,
//                          3xTF32
//   flash_dq_tf32_kernel   replaces _dq_kernel  (dq by recompute), f32, 3xTF32
//   flash_dkv_tf32_kernel  replaces _dkv_kernel (dk, dv by recompute), f32, 3xTF32
//   flash_fwd_mma_kernel   replaces _fwd_kernel, bf16
//   flash_dq_mma_kernel    replaces _dq_kernel,  bf16
//   flash_dkv_mma_kernel   replaces _dkv_kernel, bf16
//
// Every kernel takes the causal flag, the window and a hop offset q_offset (the TPU kernels'
// static q_offset and traced q_offset_dyn in one runtime int): the query positions sit
// q_offset past the keys' origin in the masks and in the live-tile ranges, for the ring
// schedules' hops (parallel/ring_attention.py), any sign; see visible() below.
//
// Operands are [B, S, H, D] tensors read through their strides (D contiguous), so the
// q/k/v views that a fused qkv projection hands over need no copy; outputs are contiguous
// [B, S, H, D], and lse and delta are contiguous f32 [B, H, S]. Every product is taken in
// f32 or with f32 accumulation (a bf16 x bf16 product is exact in f32; f32 products are
// split into three TF32 products). p (forward, dk/dv) and ds (dq, dk/dv) are rounded to
// the input type where they enter a product, where the TPU kernels narrow them
// (pallas_attention.py:541, :711, :780, :786), so kernel and plain version round at the
// same places; for f32 that is no rounding.
//
// What bounds them: at the trainer's shapes (S = 2048, D = 16 f32; D = 128 bf16) the work
// is 4·B·H·S²·D flops forward and 6 (dq) and 8 (dk/dv) backward against O(B·S·H·D) bytes,
// so all of them are bound by arithmetic, not by memory: by the tensor cores' rate — bf16,
// or TF32 taken three times for f32 (3xTF32). Every kernel keeps the S x S scores out of
// device memory and walks only the key (or query) tiles that the causal mask and the
// window leave live.
//
// Tiling. A block of 4 warps owns one (b, h) and one tile of 64 query rows (forward, dq)
// or 64 key rows (dk/dv), 16 a warp, and loops over the tiles of the other side inside the
// block: the TPU's sequential grid axis becomes that loop, and each block writes only its
// own rows, so no sum crosses blocks and no atomics are needed. The walked tiles are copied
// 16 bytes at a time with cp.async and double-buffered, so the wrappers refuse operands
// that are not 16-byte aligned.
//
// The designs: see the notes above flash_fwd_mma_kernel, the bf16 section and the 3xTF32
// section. Later work: wgmma with TMA loads and a producer warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaskValue = -1e30f;   // ops/attention.py MASK_VALUE
constexpr int kTile = 64;              // query rows and key rows per tile
constexpr int kF32 = 0, kBF16 = 1;     // dtype codes of the C interface
using bf16 = __nv_bfloat16;

// A [B, S, H, D] tensor read through its element strides; D is contiguous.
struct Operand {
  const void* ptr;
  int64_t sb, ss, sh;
};

// ops/attention.py's mask: causal keeps k <= q, the window keeps |q - k| < window. q is the
// query's position in the keys' frame: its row plus the hop offset q_offset, the TPU
// kernels' q_offset (pallas_attention.py::_visibility_mask), which a ring hop sets to
// delta·C and which may be negative. The mask depends on q - k alone, so the dk/dv kernels
// shift the key instead (k - q_offset in the queries' frame).
__device__ __forceinline__ bool visible(int q, int k, int causal, int window) {
  if (causal && q < k) return false;
  if (window > 0 && (q - k >= window || k - q >= window)) return false;
  return true;
}

// a / b rounded down (b > 0). C's / rounds toward zero, which is wrong for the negative
// numerators a hop offset gives; the JAX kernels' // floors.
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// Key tiles [lo, hi) that hold a visible key for some row of the query tile whose first
// row sits at position q0 in the keys' frame (offset included). The range may be empty
// (lo >= hi): a hop's tile that sees none of these keys. The kernels then walk nothing
// and write out = 0, lse = kMaskValue (the JAX kernels' m + log(l_safe)), dq = 0.
__device__ __forceinline__ void live_key_tiles(int q0, int S, int causal, int window,
                                               int* lo, int* hi) {
  const int q_last = q0 + kTile - 1;
  int a = 0, b = S / kTile;
  if (causal) b = min(b, floor_div(q_last, kTile) + 1);
  if (window > 0) {
    a = max(a, floor_div(q0 - window + 1, kTile));  // oldest key the tile's rows see
    if (!causal) b = min(b, floor_div(q_last + window - 1, kTile) + 1);
  }
  *lo = a;
  *hi = b;
}

// Query tiles [lo, hi) with a row that sees some key of the key tile whose first key sits
// at position k0 in the queries' frame (k0 - q_offset); empty when none does (dk = dv = 0).
__device__ __forceinline__ void live_query_tiles(int k0, int S, int causal, int window,
                                                 int* lo, int* hi) {
  const int k_last = k0 + kTile - 1;
  int a = 0, b = S / kTile;
  if (causal) a = max(a, floor_div(k0, kTile));
  if (window > 0) {
    b = min(b, floor_div(k_last + window - 1, kTile) + 1);  // youngest query that sees it
    if (!causal) a = max(a, floor_div(k0 - window + 1, kTile));
  }
  *lo = a;
  *hi = b;
}

template <typename T>
__device__ __forceinline__ const T* slice(const Operand& x, int b, int h) {
  return static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh;
}

// ---------------------------------------------------------------------------------------
// The bf16 kernels on the tensor cores
// ---------------------------------------------------------------------------------------
//
// flash_fwd_mma_kernel replaces ops/pallas_attention.py::_fwd_kernel for bf16 operands;
// see the note above it. flash_dq_mma_kernel replaces _dq_kernel and flash_dkv_mma_kernel
// replaces _dkv_kernel for bf16 operands. They compute what the TPU kernels compute —
// p = exp(q·kᵀ·scale − lse) recomputed, ds = p∘(dO·vᵀ − Δ), dq = scale·Σ ds·k,
// dk = scale·Σ dsᵀ·q, dv = Σ pᵀ·dO, with p and ds rounded to bf16 where they enter a
// product — and are bound by the tensor cores' bf16 rate (6 and 8 products of 2·D flops
// per visible pair against O(B·S·H·D) bytes). What the design does about it:
//
// - Every product is mma.sync.m16n8k16 bf16 x bf16 -> f32. A block of 4 warps owns 64 rows
//   (queries for dq, keys for dk/dv); each warp owns 16 of them and all 64 columns of the
//   walked tile. dq forms S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K; dk/dv forms Sᵀ = K·Qᵀ
//   and dPᵀ = V·dOᵀ directly, then dV += Pᵀ·dO and dK += dSᵀ·Q. Operand fragments come
//   from shared memory by ldmatrix (.trans for the right-hand operand of the second
//   products, which is stored row-major [walked row][D]).
// - p and ds never leave registers: the f32 accumulators of two neighbouring n8 tiles,
//   rounded with __float22bfloat162_rn, are exactly the A fragment of the next m16n8k16
//   product, and that rounding is the one the plain version does.
// - Operands stay bf16 in shared memory with rows padded by 8 elements (16 bytes), so
//   the eight 16-byte rows that one ldmatrix phase reads fall in distinct banks. Tiles are
//   copied with cp.async 16 bytes at a time through the operands' strides (the wrapper
//   refuses pointers and strides that are not 16-byte aligned), and the walked side is
//   double-buffered: tile n + 1's copies are in flight while tile n's products run, with
//   one barrier a tile.
// - The statistics: the dq kernel keeps its rows' lse and Δ in registers for the whole
//   walk; the dk/dv kernel stages each query tile's lse and Δ with the tile and reads the
//   columns it needs from shared memory.
// - Masks cost only where they cut a tile: the per-element test runs on tiles that the
//   causal diagonal or the window edge crosses, and interior tiles skip it (the JAX
//   package's _block_interior).
//
// Registers: a dk/dv thread holds 2 x D/2 f32 accumulators (128 at D = 128) besides its
// score tiles, so at D = 128 it walks each 64-query tile in two passes of 32 columns and
// stays within 255 registers without spilling; dq takes one pass of 64. Shared memory is
// 6 tiles of 64 x (D + 8) bf16 (104 KB at D = 128), so two blocks fit an SM. Left for
// later, for the forward too: wgmma with TMA and a producer warp (these products wait on
// ldmatrix traffic that wgmma would read from shared memory itself).

constexpr int kMmaThreads = 128;       // 4 warps x 16 rows of the block's 64-row tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a·b for one 16 x 8 tile: a is the 16 x 16 A fragment, (b0, b1) the 16 x 8 B one.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// (lo, hi) rounded to bf16 (to nearest even, as torch's .to(bfloat16)), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// True when every (query, key) pair of the tile at (q0, k0) is visible; q0 in the keys'
// frame (offset included).
__device__ __forceinline__ bool tile_interior(int q0, int k0, int causal, int window) {
  const int back = q0 + kTile - 1 - k0;    // the largest q - k in the tile
  const int ahead = k0 + kTile - 1 - q0;   // the largest k - q
  if (causal && ahead > 0) return false;
  return window <= 0 || (back < window && ahead < window);
}

// Rows [row0, row0 + kTile) of one (b, h) slice into a tile whose rows are padded by 16
// bytes ([kTile][D + 8] bf16, [kTile][D + 4] f32), with one 16-byte cp.async per chunk.
template <int D, typename T>
__device__ __forceinline__ void cp_tile(T* tile, const T* base, int64_t row_stride,
                                        int row0) {
  constexpr int kPer = 16 / sizeof(T), kChunks = D / kPer, LD = D + kPer;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int idx = i * kMmaThreads + threadIdx.x;
    const int r = idx / kChunks, c = (idx % kChunks) * kPer;
    cp_async16(tile + r * LD + c, base + static_cast<int64_t>(row0 + r) * row_stride + c);
  }
}

// Lane offsets (in elements, within a [kTile][D + 8] tile) of the rows that ldmatrix.x4
// reads. A fragment of a warp's 16 rows: rows lane % 16, column half lane / 16. B fragments
// of two n8 tiles from a [n][k] tile: n rows (lane / 16)·8 + lane % 8, k half (lane / 8) % 2.
// The same from a [k][n] tile through .trans: k rows ((lane / 8) % 2)·8 + lane % 8, n half
// lane / 16.
template <int D> struct FragOffsets {
  int a, b, bt;
  __device__ __forceinline__ FragOffsets(int warp, int lane) {
    constexpr int LD = D + 8;
    a = (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
    b = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
    bt = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
  }
};

// Two 16 x 8·NJ products of one warp over the D columns of the operands: x = A·Bᵀ and
// y = C·Dᵀ, where A and C are the warp's 16 rows (at offset off.a) and B, D the 8·NJ rows
// of the walked tile from row c0 on.
template <int D, int NJ>
__device__ __forceinline__ void score_tiles(const bf16* A, const bf16* B, const bf16* C,
                                            const bf16* Dm, const FragOffsets<D>& off, int c0,
                                            float (&x)[NJ][4], float (&y)[NJ][4]) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], c[4];
    ldmatrix_x4(a, A + off.a + 16 * kk);
    ldmatrix_x4(c, C + off.a + 16 * kk);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t b[4], d[4];
      ldmatrix_x4(b, B + off.b + (c0 + 16 * jp) * LD + 16 * kk);
      ldmatrix_x4(d, Dm + off.b + (c0 + 16 * jp) * LD + 16 * kk);
      mma_bf16(x[2 * jp], a, b[0], b[1]);
      mma_bf16(x[2 * jp + 1], a, b[2], b[3]);
      mma_bf16(y[2 * jp], c, d[0], d[1]);
      mma_bf16(y[2 * jp + 1], c, d[2], d[3]);
    }
  }
}

// acc += frag·T for the warp's 16 rows, where frag holds NK 16 x 16 A fragments (walked
// columns c0 to c0 + 16·NK) and T is the walked [kTile][D + 8] tile, read through
// ldmatrix.trans.
template <int D, int NK>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const uint32_t (&frag)[NK][4],
                                           const bf16* tile, const FragOffsets<D>& off, int c0) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + off.bt + (c0 + 16 * kk) * LD + 16 * n);
      mma_bf16(acc[2 * n], frag[kk], b[0], b[1]);
      mma_bf16(acc[2 * n + 1], frag[kk], b[2], b[3]);
    }
}

// One warp's p and ds from its score tiles s and dp (accumulator layout: value e of n8
// tile j sits at row g + 8·(e / 2), column 8·j + 2·t + e % 2, with g = lane / 4 and
// t = lane % 4), rounded to bf16 and packed as the A fragments of the next products: the
// values of tiles 2·kk and 2·kk + 1 are fragment kk. stat(e, j) gives (lse, Δ) and pos(e, j)
// the (query, key) position of a value; kMasked applies the mask, p = 0 where not visible.
template <bool kMasked, int NJ, typename Stat, typename Pos>
__device__ __forceinline__ void softmax_grads(const float (&s)[NJ][4], const float (&dp)[NJ][4],
                                              float scale, int causal, int window,
                                              const Stat& stat, const Pos& pos,
                                              uint32_t (&p_frag)[NJ / 2][4],
                                              uint32_t (&ds_frag)[NJ / 2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 ld = stat(e, j);
      bool vis = true;
      if constexpr (kMasked) {
        const int2 qk = pos(e, j);
        vis = visible(qk.x, qk.y, causal, window);
      }
      // s·scale rounded before lse is taken off, as the plain version does (no FMA)
      p[e] = vis ? expf(__fsub_rn(__fmul_rn(s[j][e], scale), ld.x)) : 0.f;
      ds[e] = p[e] * (dp[j][e] - ld.y);
    }
    p_frag[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    p_frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    ds_frag[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
    ds_frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// One warp's 16 output rows (row0 + g and row0 + g + 8, this thread's columns 8·j + 2·t)
// of a contiguous [B, S, H, D] bf16 tensor, times mult.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], int b,
                                           int row, int S, int H, int h, int t, float mult) {
  bf16* r0 = out + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
  bf16* r8 = r0 + static_cast<int64_t>(8) * H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * j) =
        __float22bfloat162_rn(make_float2(acc[j][0] * mult, acc[j][1] * mult));
    *reinterpret_cast<__nv_bfloat162*>(r8 + 8 * j) =
        __float22bfloat162_rn(make_float2(acc[j][2] * mult, acc[j][3] * mult));
  }
}

template <int D> constexpr size_t mma_tile_bytes() { return kTile * (D + 8) * sizeof(bf16); }

// n8 tiles of the walked tile per pass of the dk/dv kernel: at D = 128 it takes the tile's
// 64 columns in two passes of 32, so that a thread's 2 x 64 accumulators and its score
// tiles fit in 255 registers without spilling. The dq kernel takes all 64 in one pass.
template <int D> constexpr int kDkvPassTiles = D == 128 ? 4 : 8;

// S = Q·Kᵀ for one warp's 16 rows against the 64 keys of a [kTile][D + 8] tile, from the
// warp's Q fragments held in registers (D/16 A fragments of 16 x 16).
template <int D>
__device__ __forceinline__ void score_tile(const uint32_t (&qf)[D / 16][4], const bf16* K,
                                           const FragOffsets<D>& off, float (&x)[8][4]) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, K + off.b + 16 * jp * LD + 16 * kk);
      mma_bf16(x[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(x[2 * jp + 1], qf[kk], b[2], b[3]);
    }
}

// One step of the online softmax for one warp's score tile s (accumulator layout, as in
// softmax_grads: this thread holds rows row and row + 8, columns 8·j + 2·t + e % 2 of the
// key tile at k0). Updates the running max m and sum l of its two rows, returns each row's
// correction exp(m_old − m_new) in corr, and packs p, rounded to bf16, as the A fragments
// of P·V. The row max and sum go over the quad of lanes that share a row (xor 1, 2).
template <bool kMasked>
__device__ __forceinline__ void online_softmax(const float (&s)[8][4], float scale, int row,
                                               int k0, int t, int causal, int window,
                                               float (&m)[2], float (&l)[2], float (&corr)[2],
                                               uint32_t (&p_frag)[4][4]) {
  float x[8][4], mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // s·scale rounded, as the plain version's product then scale (no FMA below)
      float v = __fmul_rn(s[j][e], scale);
      if constexpr (kMasked) {
        if (!visible(row + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), causal, window))
          v = kMaskValue;
      }
      x[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new[r]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = expf(__fsub_rn(x[j][e], m_new[e >> 1]));
      if constexpr (kMasked) {
        if (!visible(row + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), causal, window))
          p[e] = 0.f;
      }
      sum[e >> 1] += p[e];     // l sums the f32 p, before rounding, as the plain version
    }
    p_frag[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    p_frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
    m[r] = m_new[r];
  }
}

// Replaces ops/pallas_attention.py::_fwd_kernel for bf16 operands.
// The online softmax of the TPU kernel — per live key tile, m_new = max(m, max_k s),
// corr = exp(m − m_new), p = exp(s·scale − m_new) (0 where masked), acc = acc·corr + p·v,
// l = l·corr + Σ p; then out = acc / l and lse = m + log(l), with l == 0 guarded — and
// bound, like the backward, by the tensor cores' bf16 rate (2 products of 2·D flops per
// visible pair against O(B·S·H·D) bytes). The design is the dq kernel's with one product
// fewer before the softmax:
//
// - A block of 4 warps owns one (b, h) and 64 query rows, 16 a warp, and walks the live
//   64-key tiles of K and V, double-buffered in shared memory (cp.async, one barrier a
//   tile). A warp's Q fragments stay in registers for the whole walk.
// - S = Q·Kᵀ and then P·V are mma.sync.m16n8k16 bf16 x bf16 -> f32 products. The softmax
//   runs in the accumulator layout: each thread holds two rows' worth of the warp's 16 x 64
//   score tile, so the row max and sum take two shuffles within a quad, and no statistic
//   goes through shared memory. p, rounded to bf16 where the plain version rounds it, is
//   packed straight into the A fragments of P·V: it never leaves registers.
// - The mask runs only on tiles that the band edge crosses (tile_interior).
//
// Registers at D = 128: 64 f32 accumulators, 32 words of Q fragments and the 32 scores.
// Shared memory: Q, then two stages of K and two of V (85 KB at D = 128; two blocks an SM).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(Operand q, Operand k, Operand v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale, int causal,
                     int window, int q_offset) {
  constexpr int TILE = kTile * (D + 8);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(mma_smem);
  bf16* sK = sQ + TILE;
  bf16* sV = sK + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = slice<bf16>(k, b, h);
  const bf16* vb = slice<bf16>(v, b, h);
  const FragOffsets<D> off(warp, lane);
  int kt_lo, kt_hi;
  live_key_tiles(q0 + q_offset, S, causal, window, &kt_lo, &kt_hi);

  cp_tile<D>(sQ, slice<bf16>(q, b, h), q.ss, q0);
  if (kt_lo < kt_hi) {
    cp_tile<D>(sK, kb, k.ss, kt_lo * kTile);
    cp_tile<D>(sV, vb, v.ss, kt_lo * kTile);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], sQ + off.a + 16 * kk);

  const int row = q0 + 16 * warp + g;       // this thread's rows: row and row + 8
  float acc[D / 8][4], m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();              // tile kt is in, and every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {         // ... whose buffers now take tile kt + 1
      cp_tile<D>(sK + (stage ^ 1) * TILE, kb, k.ss, (kt + 1) * kTile);
      cp_tile<D>(sV + (stage ^ 1) * TILE, vb, v.ss, (kt + 1) * kTile);
      cp_async_commit();
    }
    const int k0 = kt * kTile;
    float s[8][4], corr[2];
    uint32_t p_frag[4][4];
    score_tile<D>(qf, sK + stage * TILE, off, s);
    if (tile_interior(q0 + q_offset, k0, causal, window))
      online_softmax<false>(s, scale, row + q_offset, k0, t, causal, window, m, l, corr,
                            p_frag);
    else
      online_softmax<true>(s, scale, row + q_offset, k0, t, causal, window, m, l, corr,
                           p_frag);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    accumulate<D>(acc, p_frag, sV + stage * TILE, off, 0);
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {   // IEEE division, as the plain version's acc / l
    acc[j][0] /= l_safe[0];
    acc[j][1] /= l_safe[0];
    acc[j][2] /= l_safe[1];
    acc[j][3] /= l_safe[1];
  }
  store_rows<D>(out, acc, b, row, S, H, h, t, 1.f);
  if (t == 0) {
    float* lse_row = lse + (static_cast<int64_t>(b) * H + h) * S + row;
    lse_row[0] = m[0] + logf(l_safe[0]);
    lse_row[8] = m[1] + logf(l_safe[1]);
  }
}

// Replaces ops/pallas_attention.py::_dq_kernel for bf16 operands (design note above).
// Shared memory: Q and dO, then two stages of K and V.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(Operand q, Operand k, Operand v, Operand dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int H, float scale, int causal, int window,
                    int q_offset) {
  constexpr int TILE = kTile * (D + 8), NJ = 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(mma_smem);
  bf16* sDO = sQ + TILE;
  bf16* sK = sDO + TILE;
  bf16* sV = sK + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = slice<bf16>(k, b, h);
  const bf16* vb = slice<bf16>(v, b, h);
  const FragOffsets<D> off(warp, lane);
  int kt_lo, kt_hi;
  live_key_tiles(q0 + q_offset, S, causal, window, &kt_lo, &kt_hi);

  cp_tile<D>(sQ, slice<bf16>(q, b, h), q.ss, q0);
  cp_tile<D>(sDO, slice<bf16>(dout, b, h), dout.ss, q0);
  if (kt_lo < kt_hi) {
    cp_tile<D>(sK, kb, k.ss, kt_lo * kTile);
    cp_tile<D>(sV, vb, v.ss, kt_lo * kTile);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;       // this thread's rows: row and row + 8
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S + row;
  const float2 stat_r[2] = {make_float2(lse[stat], delta[stat]),
                            make_float2(lse[stat + 8], delta[stat + 8])};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();              // tile kt is in, and every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {         // ... whose buffers now take tile kt + 1
      cp_tile<D>(sK + (stage ^ 1) * TILE, kb, k.ss, (kt + 1) * kTile);
      cp_tile<D>(sV + (stage ^ 1) * TILE, vb, v.ss, (kt + 1) * kTile);
      cp_async_commit();
    }
    const bf16* tK = sK + stage * TILE;
    const bf16* tV = sV + stage * TILE;
    const int k0 = kt * kTile;
    const bool interior = tile_interior(q0 + q_offset, k0, causal, window);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NJ) {   // the tile's keys, 8·NJ at a time
      float s[NJ][4], dp[NJ][4];
      score_tiles<D, NJ>(sQ, tK, sDO, tV, off, c0, s, dp);
      const auto stat_of = [&](int e, int) { return stat_r[e >> 1]; };
      const auto pos_of = [&](int e, int j) {
        return make_int2(row + q_offset + 8 * (e >> 1), k0 + c0 + 8 * j + 2 * t + (e & 1));
      };
      uint32_t p_frag[NJ / 2][4], ds_frag[NJ / 2][4];
      if (interior)
        softmax_grads<false>(s, dp, scale, causal, window, stat_of, pos_of, p_frag, ds_frag);
      else
        softmax_grads<true>(s, dp, scale, causal, window, stat_of, pos_of, p_frag, ds_frag);
      accumulate<D>(acc, ds_frag, tK, off, c0);
    }
  }
  store_rows<D>(dq, acc, b, row, S, H, h, t, scale);
}

// Replaces ops/pallas_attention.py::_dkv_kernel for bf16 operands (design note above).
// Shared memory: K and V, then two stages of Q, dO, lse and Δ.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(Operand q, Operand k, Operand v, Operand dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, float scale,
                     int causal, int window, int q_offset) {
  constexpr int TILE = kTile * (D + 8), NJ = kDkvPassTiles<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sK = reinterpret_cast<bf16*>(mma_smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;
  bf16* sDO = sQ + 2 * TILE;
  float* sStat = reinterpret_cast<float*>(sDO + 2 * TILE);   // [2 stages][lse, Δ][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const bf16* qb = slice<bf16>(q, b, h);
  const bf16* dob = slice<bf16>(dout, b, h);
  const FragOffsets<D> off(warp, lane);
  int qt_lo, qt_hi;
  // The key tile in the queries' frame: the mask depends on q - k alone, so the offset
  // moves the keys and the query tiles keep their own positions.
  const int kq0 = k0 - q_offset;
  live_query_tiles(kq0, S, causal, window, &qt_lo, &qt_hi);

  // The query tile qt's rows of Q and dO, and its lse and Δ (16 floats a warp-quarter).
  const auto stage_queries = [&](int st, int qt) {
    cp_tile<D>(sQ + st * TILE, qb, q.ss, qt * kTile);
    cp_tile<D>(sDO + st * TILE, dob, dout.ss, qt * kTile);
    if (threadIdx.x < 32) {
      const int which = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;
      cp_async16(sStat + (2 * st + which) * kTile + c,
                 (which ? delta : lse) + stat + qt * kTile + c);
    }
  };
  cp_tile<D>(sK, slice<bf16>(k, b, h), k.ss, k0);
  cp_tile<D>(sV, slice<bf16>(v, b, h), v.ss, k0);
  if (qt_lo < qt_hi) stage_queries(0, qt_lo);
  cp_async_commit();

  const int key = kq0 + 16 * warp + g;      // this thread's rows key and key + 8, shifted
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // the stage toggles (tile qt's buffers), so qt_lo is not live in the walk: with it
  // and the hop offset, ptxas spilled dk/dv at D = 64 (f32) and D = 128 (bf16)
  int stage = 1;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    stage ^= 1;
    cp_async_wait_all();
    __syncthreads();              // tile qt is in, and every warp is done with tile qt - 1
    if (qt + 1 < qt_hi) {
      stage_queries(stage ^ 1, qt + 1);
      cp_async_commit();
    }
    const bf16* tQ = sQ + stage * TILE;
    const bf16* tDO = sDO + stage * TILE;
    const float* tLse = sStat + 2 * stage * kTile;
    const float* tDelta = tLse + kTile;
    const int q0 = qt * kTile;
    const bool interior = tile_interior(q0, kq0, causal, window);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NJ) {   // the tile's queries, 8·NJ at a time
      float s[NJ][4], dp[NJ][4];  // Sᵀ and dPᵀ: rows are keys, columns queries
      score_tiles<D, NJ>(sK, tQ, sV, tDO, off, c0, s, dp);
      const auto stat_of = [&](int e, int j) {
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        return make_float2(tLse[c], tDelta[c]);
      };
      const auto pos_of = [&](int e, int j) {
        return make_int2(q0 + c0 + 8 * j + 2 * t + (e & 1), key + 8 * (e >> 1));
      };
      uint32_t p_frag[NJ / 2][4], ds_frag[NJ / 2][4];
      if (interior)
        softmax_grads<false>(s, dp, scale, causal, window, stat_of, pos_of, p_frag, ds_frag);
      else
        softmax_grads<true>(s, dp, scale, causal, window, stat_of, pos_of, p_frag, ds_frag);
      accumulate<D>(acc_v, p_frag, tDO, off, c0);
      accumulate<D>(acc_k, ds_frag, tQ, off, c0);
    }
  }
  store_rows<D>(dk, acc_k, b, key + q_offset, S, H, h, t, scale);
  store_rows<D>(dv, acc_v, b, key + q_offset, S, H, h, t, 1.f);
}

// ---------------------------------------------------------------------------------------
// The f32 kernels on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------------------
//
// flash_fwd_tf32_kernel replaces ops/pallas_attention.py::_fwd_kernel,
// flash_dq_tf32_kernel replaces _dq_kernel and flash_dkv_tf32_kernel replaces _dkv_kernel
// for f32 operands. They compute what the bf16 kernels compute — the online-softmax forward
// (out and lse), and the backward's p = exp(q·kᵀ·scale − lse) recomputed (0 where masked),
// ds = p∘(dO·vᵀ − Δ), dq = scale·Σ ds·k, dk = scale·Σ dsᵀ·q, dv = Σ pᵀ·dO — with p and ds
// kept in f32 (the TPU kernels narrow them to the input type, f32 here). They are bound by
// arithmetic: 4·D (forward), 6·D (dq) and 8·D (dk/dv) flops per visible pair against
// O(B·S·H·D) bytes. The CUDA cores' f32 rate is 67 TFLOP/s; the tensor cores take TF32 (a
// 10-bit mantissa) at 495. 3xTF32 keeps close to f32 accuracy on them at a third of that
// rate: each f32 operand x is split into the TF32 values hi = tf32(x) and lo = tf32(x − hi)
// (rounded as cvt.rna.tf32.f32 rounds, see tf32_bits), and a·b is taken as
// lo_a·hi_b + hi_a·lo_b + hi_a·hi_b into one f32 accumulator, the small terms first so
// that they are not lost behind the large one (lo·lo, ~2^-22 of a·b, is left out). The
// design is the bf16 kernels', carried to TF32:
//
// - Every product is mma.sync.m16n8k8 tf32 x tf32 -> f32, three times. A block of 4 warps
//   owns 64 rows (queries for the forward and dq, keys for dk/dv), 16 a warp, against the
//   walked 64-row tile. The forward forms S = Q·Kᵀ, then O += P·V; dq forms S = Q·Kᵀ and
//   dP = dO·Vᵀ, then dQ += dS·K; dk/dv forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, so that
//   pᵀ and dsᵀ come out in the rows of dV += Pᵀ·dO and dK += dSᵀ·Q.
// - The forward's online softmax runs in the accumulator layout, as the bf16 forward's:
//   the row max and sum take two shuffles within a quad, the running m and l of a
//   thread's two rows stay in registers, and m is kept in base 2 (the max of s·scale·log2 e)
//   so that p = exp2(s·scale·log2 e − m) and the correction exp2(m_old − m_new) are each one
//   ex2.approx; lse = m·ln 2 + log(l) is written in base e, as the backward reads it.
// - p and ds go from the score accumulators into the next product's A fragments in
//   registers, split once per score. The register layouts differ: the m16n8 accumulator
//   holds columns 2t and 2t + 1 of rows g and g + 8 (g = lane / 4, t = lane % 4), the
//   m16n8k8 TF32 A fragment columns t and t + 4. So the second product takes its k (the
//   walked rows) in a permuted order — k = t is walked row 2t and k = t + 4 is row 2t + 1
//   of each group of 8 — and reads its B operand from shared memory in that order. A sum
//   does not care about the order, and no value crosses lanes (no shuffle).
// - Tiles stay f32 in shared memory with rows padded by 4 floats (16 bytes): at a row
//   stride of D + 4 ≡ 4 (mod 16) words, each fragment read of a warp — 8 rows by 4
//   columns, or 4 row pairs by 8 columns — falls in 32 distinct banks. Fragments come
//   from shared memory by 32-bit loads (ldmatrix moves 16-bit elements). Tiles are copied
//   with cp.async 16 bytes at a time through the operands' strides (the wrapper refuses
//   operands that are not 16-byte aligned), and the walked side is double-buffered, with
//   one barrier a tile.
// - Splits, at D = 16 (the composed trainer's width, where the splits cost most beside the
//   products): each element once. A warp splits its own 16 rows (Q for the forward, Q and
//   dO for dq, K and V for dk/dv) and holds their hi and lo fragments in registers for the whole walk (32
//   registers); each walked tile is split where it lands — each thread splits the chunks
//   it copied, after its own cp.async wait and before the tile's barrier, hi in place and
//   lo into a tile of its own — instead of by each of the 4 warps that read it. At D = 64
//   and 128 the held fragments would take 128 and 256 registers and the lo tiles push
//   shared memory down to one block an SM (D = 64) or past the SM (D = 128), so there
//   both sides are split where their fragments are read.
// - p = exp2(s·(scale·log2 e) − lse·log2 e) in the backward, exp2(s·(scale·log2 e) − m) in
//   the forward: one FFMA and one ex2.approx, the scale and the change of base folded into
//   the argument. The per-pair work besides the products — that, ds, and the splits of p
//   and ds — costs as much as the products at D = 16, so each split is five instructions
//   (tf32_bits twice and a subtraction).
// - Masks cost only where they cut a tile (tile_interior), as in the bf16 kernels.
//
// A backward pass takes the scores of NJ n8 tiles of the walked tile at once
// (kTf32PassTiles), then feeds them, tile by tile, into the second products: 32 walked rows
// a pass, but dk/dv, which holds 2 x D/2 f32 accumulators a thread, takes 16 at D = 64 and
// 8 at D = 128, so that it stays within 255 registers without spilling (ptxas spilled at 32
// and 16 rows a pass). The forward takes the whole 64-key tile in one pass, as the row max
// needs all of it: 32 scores and D/2 accumulators a thread (64 at D = 128); at D = 16 it
// spreads P·V over 4 independent sets of accumulators (kTf32FwdAccSets), added at the
// end, which shortens each sum's chain of dependent products and sums in a shape closer to
// the plain version's per-tile products (flash_probe.py times it against one set and
// prints how far the two lie apart). Shared memory:
// f32 tiles of 64 x (D + 4); the forward 9 at D = 16 (45 KB) and 5 at D = 64 and 128 (85
// and 165 KB); dq 10 at D = 16 (50 KB), 6 at D = 64 and 128 (102 and 198 KB; one block an
// SM at D = 128).

constexpr float kLog2e = 1.4426950408889634f;

// n8 tiles of the walked tile per pass (see above).
template <int D, bool kDkv> constexpr int kTf32PassTiles = !kDkv || D == 16 ? 4 : 128 / D;
// Independent sets of the forward's P·V sums (see above).
template <int D> constexpr int kTf32FwdAccSets = D == 16 ? 4 : 1;

// Where the splits are made (see above): at D = 16 once — the own rows held in registers,
// the walked tiles split in shared memory as they land, into 4 more tiles (lo parts);
// at D = 64 and 128 where they are read.
template <int D> constexpr bool kTf32SplitOnce = D == 16;

// Shared memory: the own tiles (Q for the forward; Q and dO for dq, K and V for dk/dv),
// 2 stages of 2 walked tiles, and 2 stages of their lo parts where the walked tiles are
// split as they land; dk/dv adds 2 stages of lse and Δ.
template <int D> constexpr size_t tf32_fwd_bytes() {
  return (5 + (kTf32SplitOnce<D> ? 4 : 0)) * kTile * (D + 4) * sizeof(float);
}
template <int D> constexpr size_t tf32_dq_bytes() {
  return tf32_fwd_bytes<D>() + kTile * (D + 4) * sizeof(float);
}
template <int D> constexpr size_t tf32_dkv_bytes() {
  return tf32_dq_bytes<D>() + 4 * kTile * sizeof(float);
}

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero), as its f32 bits:
// cvt.rna.tf32.f32's result for every finite x, taken on the bits — add half a TF32 ulp
// and clear the 13 bits below the TF32 mantissa (CUTLASS's fast-f32 rounding). Two integer
// instructions, where ptxas makes five of the cvt (it also tests for NaN and infinity).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x by the special-function unit in one instruction (relative error ~2^-22; results below
// 2^-126 flush to 0, where exp2f would spend instructions on them).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as hi + lo, both TF32: hi = tf32(x), lo = tf32(x − hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// c += a·b for one 16 x 8 tile in TF32: a is the 16 x 8 A fragment, (b0, b1) the 8 x 8 B one.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// An m16n8k8 A fragment (a0: row g, column t; a1: g + 8, t; a2: g, t + 4; a3: g + 8, t + 4)
// and B fragment (b0: row t, column g; b1: t + 4, g), each as TF32 hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a·b in 3xTF32: the two small cross terms, then the large one.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of k-step kk from 16 rows (row0 on) of an f32 [kTile][D + 4] tile.
template <int D>
__device__ __forceinline__ FragA frag_a(const float* tile, int row0, int kk, int g, int t) {
  constexpr int LD = D + 4;
  const float* p = tile + (row0 + g) * LD + 8 * kk + t;
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * LD], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * LD + 4], f.hi[3], f.lo[3]);
  return f;
}

// The walked tile as B fragments, each element split into hi and lo: split where it is read
// from the raw f32 tile, or read split from the hi and lo tiles (kPresplit, split_tile).
template <int D, bool kPresplit>
struct WalkedTile {
  const float* tile;   // the raw f32 rows, or their hi parts (kPresplit)
  const float* lo;     // their lo parts (kPresplit)
  __device__ __forceinline__ void part(int off, uint32_t& hi, uint32_t& lo_) const {
    if constexpr (kPresplit) {
      hi = __float_as_uint(tile[off]);
      lo_ = __float_as_uint(lo[off]);
    } else {
      split_tf32(tile[off], hi, lo_);
    }
  }
  // The B fragment of k-step kk of a first product (x = A·Wᵀ, k over D): Wᵀ's columns
  // are the walked rows n0 .. n0 + 7.
  __device__ __forceinline__ FragB rows(int n0, int kk, int g, int t) const {
    const int off = (n0 + g) * (D + 4) + 8 * kk + t;
    FragB f;
    part(off, f.hi[0], f.lo[0]);
    part(off + 4, f.hi[1], f.lo[1]);
    return f;
  }
  // The B fragment of a second product (acc += P·W, k over the walked rows k0 .. k0 + 7
  // in the permuted order: k = t is row k0 + 2t, k = t + 4 is row k0 + 2t + 1) for the
  // output columns n0 .. n0 + 7.
  __device__ __forceinline__ FragB cols(int k0, int n0, int g, int t) const {
    const int off = (k0 + 2 * t) * (D + 4) + n0 + g;
    FragB f;
    part(off, f.hi[0], f.lo[0]);
    part(off + D + 4, f.hi[1], f.lo[1]);
    return f;
  }
};

// Splits the chunks of a [kTile][D + 4] f32 tile that this thread copied with cp_tile, in
// place: hi into the tile, lo into lo_tile at the same offsets. A thread reads back only its
// own cp.async writes, which cp_async_wait_all has made visible to it, so the split needs no
// barrier of its own: the tile's barrier publishes it.
template <int D>
__device__ __forceinline__ void split_tile(float* tile, float* lo_tile) {
  constexpr int kChunks = D / 4, LD = D + 4;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int idx = i * kMmaThreads + threadIdx.x;
    const int off = (idx / kChunks) * LD + (idx % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(tile + off) = hi;
    *reinterpret_cast<uint4*>(lo_tile + off) = lo;
  }
}

// An n8 score tile in the accumulator layout (x0: row g, column 2t; x1: g, 2t + 1;
// x2: g + 8, 2t; x3: g + 8, 2t + 1) as the A fragment of the next product, in the permuted
// k order of WalkedTile::cols: k = t takes column 2t, k = t + 4 column 2t + 1.
__device__ __forceinline__ FragA frag_from_scores(const float (&x)[4]) {
  FragA f;
  split_tf32(x[0], f.hi[0], f.lo[0]);
  split_tf32(x[2], f.hi[1], f.lo[1]);
  split_tf32(x[1], f.hi[2], f.lo[2]);
  split_tf32(x[3], f.hi[3], f.lo[3]);
  return f;
}

// A warp's 16 rows of one of the block's own tiles, as A fragments: split once and held in
// registers (kHeld), or split from the tile where they are read.
template <int D, bool kHeld>
struct OwnRows {
  FragA held[kHeld ? D / 8 : 1];
  const float* tile;
  int row0;
  __device__ __forceinline__ OwnRows(const float* tile_, int row0_, int g, int t)
      : tile(tile_), row0(row0_) {
    if constexpr (kHeld) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) held[kk] = frag_a<D>(tile, row0, kk, g, t);
    }
  }
  __device__ __forceinline__ FragA frag(int kk, int g, int t) const {
    if constexpr (kHeld)
      return held[kk];
    else
      return frag_a<D>(tile, row0, kk, g, t);
  }
};

// One warp's scores x = A·Wᵀ over the D columns, for the 8 n8 tiles of a walked tile;
// A is the warp's own rows (the forward's S = Q·Kᵀ).
template <int D, bool kHeld, bool kPresplit>
__device__ __forceinline__ void tf32_score_tile(const OwnRows<D, kHeld>& A,
                                                const WalkedTile<D, kPresplit>& W, int g,
                                                int t, float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA a = A.frag(kk, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_3xtf32(x[j], a, W.rows(8 * j, kk, g, t));
  }
}

// A backward pass's first products for one warp: x = A·Wᵀ and y = C·Vᵀ over the D
// columns, for the NJ n8 tiles of walked rows c0 .. c0 + 8·NJ − 1; A and C are the warp's
// own rows.
template <int D, int NJ, bool kHeld, bool kPresplit>
__device__ __forceinline__ void tf32_scores(const OwnRows<D, kHeld>& A,
                                            const OwnRows<D, kHeld>& C,
                                            const WalkedTile<D, kPresplit>& W,
                                            const WalkedTile<D, kPresplit>& V, int c0, int g,
                                            int t, float (&x)[NJ][4], float (&y)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA a = A.frag(kk, g, t), c = C.frag(kk, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma_3xtf32(x[j], a, W.rows(c0 + 8 * j, kk, g, t));
      mma_3xtf32(y[j], c, V.rows(c0 + 8 * j, kk, g, t));
    }
  }
}

// One warp's 16 output rows (row and row + 8, this thread's columns 8·j + 2t and
// 8·j + 2t + 1) of a contiguous [B, S, H, D] f32 tensor, times mult.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[D / 8][4], int b,
                                               int row, int S, int H, int h, int t,
                                               float mult) {
  float* r0 = out + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
  float* r8 = r0 + static_cast<int64_t>(8) * H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(r0 + 8 * j) = make_float2(acc[j][0] * mult, acc[j][1] * mult);
    *reinterpret_cast<float2*>(r8 + 8 * j) = make_float2(acc[j][2] * mult, acc[j][3] * mult);
  }
}

// Replaces ops/pallas_attention.py::_fwd_kernel for f32 operands (design note above).
// Per live key tile: S = Q·Kᵀ in 3xTF32, m_new = max(m, max_k s·scale·log2 e) (base 2),
// corr = exp2(m − m_new), p = exp2(s·scale·log2 e − m_new) (0 where masked),
// acc = acc·corr + P·V in 3xTF32, l = l·corr + Σ p; then out = acc / l and
// lse = m·ln 2 + log(l), with l == 0 guarded. Shared memory: Q, then two stages of K and V
// (and of their lo parts at D = 16).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_tf32_kernel(Operand q, Operand k, Operand v, float* __restrict__ out,
                      float* __restrict__ lse, int S, int H, float scale, int causal,
                      int window, int q_offset) {
  constexpr int TILE = kTile * (D + 4), SETS = kTf32FwdAccSets<D>;
  constexpr bool kOnce = kTf32SplitOnce<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  float* sQ = reinterpret_cast<float*>(mma_smem);
  float* sK = sQ + TILE;
  float* sV = sK + 2 * TILE;
  float* sKlo = sV + 2 * TILE;              // kOnce: the lo parts of sK and sV
  float* sVlo = sKlo + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const float* kb = slice<float>(k, b, h);
  const float* vb = slice<float>(v, b, h);
  int kt_lo, kt_hi;
  live_key_tiles(q0 + q_offset, S, causal, window, &kt_lo, &kt_hi);

  cp_tile<D>(sQ, slice<float>(q, b, h), q.ss, q0);
  if (kt_lo < kt_hi) {
    cp_tile<D>(sK, kb, k.ss, kt_lo * kTile);
    cp_tile<D>(sV, vb, v.ss, kt_lo * kTile);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;       // this thread's rows: row and row + 8
  const float scale2 = scale * kLog2e;
  // P·V's sums: SETS independent sets, n8 key tile j into set j % SETS, added at the end
  float acc[SETS][D / 8][4], m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < SETS; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  const OwnRows<D, kOnce> oq(sQ, 16 * warp, g, t);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    if constexpr (kOnce) {        // split tile kt where this thread's copies landed
      split_tile<D>(sK + stage * TILE, sKlo + stage * TILE);
      split_tile<D>(sV + stage * TILE, sVlo + stage * TILE);
    }
    __syncthreads();              // tile kt is in, and every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {         // ... whose buffers now take tile kt + 1
      cp_tile<D>(sK + (stage ^ 1) * TILE, kb, k.ss, (kt + 1) * kTile);
      cp_tile<D>(sV + (stage ^ 1) * TILE, vb, v.ss, (kt + 1) * kTile);
      cp_async_commit();
    }
    const WalkedTile<D, kOnce> tK{sK + stage * TILE, sKlo + stage * TILE};
    const WalkedTile<D, kOnce> tV{sV + stage * TILE, sVlo + stage * TILE};
    const int k0 = kt * kTile;
    const auto tile_step = [&](auto masked) {
      const auto vis = [&](int e, int j) {
        if constexpr (decltype(masked)::value)
          return visible(row + q_offset + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), causal,
                         window);
        else
          return true;
      };
      float s[8][4], mx[2] = {kMaskValue, kMaskValue};
      tf32_score_tile<D>(oq, tK, g, t, s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (vis(e, j)) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r] * scale2);   // scale2 > 0: the max of s·scale2
        corr[r] = exp2_approx(m[r] - m_new[r]);
      }
#pragma unroll
      for (int i = 0; i < SETS; ++i)
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[i][j][0] *= corr[0];
          acc[i][j][1] *= corr[0];
          acc[i][j][2] *= corr[1];
          acc[i][j][3] *= corr[1];
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = vis(e, j) ? exp2_approx(fmaf(s[j][e], scale2, -m_new[e >> 1])) : 0.f;
          sum[e >> 1] += p[e];
        }
        const FragA pa = frag_from_scores(p);
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          mma_3xtf32(acc[j % SETS][n], pa, tV.cols(8 * j, 8 * n, g, t));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
    };
    if (tile_interior(q0 + q_offset, k0, causal, window))
      tile_step(std::false_type{});
    else
      tile_step(std::true_type{});
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 1; i < SETS; ++i) acc[0][j][e] += acc[i][j][e];
      acc[0][j][e] /= l_safe[e >> 1];   // IEEE division, as the plain version's acc / l
    }
  }
  store_rows_f32<D>(out, acc[0], b, row, S, H, h, t, 1.f);
  if (t == 0) {
    // a row that saw no key (l == 0, only under a hop offset) has lse = kMaskValue, as
    // the plain version's; m is in base 2 here and would give kMaskValue·ln 2
    constexpr float kLn2 = 0.6931471805599453f;
    float* lse_row = lse + (static_cast<int64_t>(b) * H + h) * S + row;
    lse_row[0] = l[0] == 0.f ? kMaskValue : m[0] * kLn2 + logf(l_safe[0]);
    lse_row[8] = l[1] == 0.f ? kMaskValue : m[1] * kLn2 + logf(l_safe[1]);
  }
}

// Replaces ops/pallas_attention.py::_dq_kernel for f32 operands (design note above).
// Shared memory: Q and dO, then two stages of K and V.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_tf32_kernel(Operand q, Operand k, Operand v, Operand dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int H, float scale, int causal,
                     int window, int q_offset) {
  constexpr int TILE = kTile * (D + 4), NJ = kTf32PassTiles<D, false>;
  constexpr bool kOnce = kTf32SplitOnce<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  float* sQ = reinterpret_cast<float*>(mma_smem);
  float* sDO = sQ + TILE;
  float* sK = sDO + TILE;
  float* sV = sK + 2 * TILE;
  float* sKlo = sV + 2 * TILE;              // kOnce: the lo parts of sK and sV
  float* sVlo = sKlo + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const float* kb = slice<float>(k, b, h);
  const float* vb = slice<float>(v, b, h);
  int kt_lo, kt_hi;
  live_key_tiles(q0 + q_offset, S, causal, window, &kt_lo, &kt_hi);

  cp_tile<D>(sQ, slice<float>(q, b, h), q.ss, q0);
  cp_tile<D>(sDO, slice<float>(dout, b, h), dout.ss, q0);
  if (kt_lo < kt_hi) {
    cp_tile<D>(sK, kb, k.ss, kt_lo * kTile);
    cp_tile<D>(sV, vb, v.ss, kt_lo * kTile);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;       // this thread's rows: row and row + 8
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S + row;
  const float neg_lse2[2] = {-lse[stat] * kLog2e, -lse[stat + 8] * kLog2e};
  const float delta_r[2] = {delta[stat], delta[stat + 8]};
  const float scale2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  const OwnRows<D, kOnce> oq(sQ, 16 * warp, g, t), odo(sDO, 16 * warp, g, t);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    if constexpr (kOnce) {        // split tile kt where this thread's copies landed
      split_tile<D>(sK + stage * TILE, sKlo + stage * TILE);
      split_tile<D>(sV + stage * TILE, sVlo + stage * TILE);
    }
    __syncthreads();              // tile kt is in, and every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {         // ... whose buffers now take tile kt + 1
      cp_tile<D>(sK + (stage ^ 1) * TILE, kb, k.ss, (kt + 1) * kTile);
      cp_tile<D>(sV + (stage ^ 1) * TILE, vb, v.ss, (kt + 1) * kTile);
      cp_async_commit();
    }
    const WalkedTile<D, kOnce> tK{sK + stage * TILE, sKlo + stage * TILE};
    const WalkedTile<D, kOnce> tV{sV + stage * TILE, sVlo + stage * TILE};
    const int k0 = kt * kTile;
    const auto tile_passes = [&](auto masked) {
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += 8 * NJ) {   // the tile's keys, 8·NJ at a time
        float s[NJ][4], dp[NJ][4];
        tf32_scores<D, NJ>(oq, odo, tK, tV, c0, g, t, s, dp);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool vis = true;
            if constexpr (decltype(masked)::value)
              vis = visible(row + q_offset + 8 * (e >> 1), k0 + c0 + 8 * j + 2 * t + (e & 1),
                            causal, window);
            const float p = vis ? exp2_approx(fmaf(s[j][e], scale2, neg_lse2[e >> 1])) : 0.f;
            ds[e] = p * (dp[j][e] - delta_r[e >> 1]);
          }
          const FragA a = frag_from_scores(ds);
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            mma_3xtf32(acc[n], a, tK.cols(c0 + 8 * j, 8 * n, g, t));
        }
      }
    };
    if (tile_interior(q0 + q_offset, k0, causal, window))
      tile_passes(std::false_type{});
    else
      tile_passes(std::true_type{});
  }
  store_rows_f32<D>(dq, acc, b, row, S, H, h, t, scale);
}

// Replaces ops/pallas_attention.py::_dkv_kernel for f32 operands (design note above).
// Shared memory: K and V, then two stages of Q, dO, lse and Δ.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_tf32_kernel(Operand q, Operand k, Operand v, Operand dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                      float scale, int causal, int window, int q_offset) {
  constexpr int TILE = kTile * (D + 4), NJ = kTf32PassTiles<D, true>;
  constexpr bool kOnce = kTf32SplitOnce<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  float* sK = reinterpret_cast<float*>(mma_smem);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;
  float* sDO = sQ + 2 * TILE;
  float* sQlo = sDO + 2 * TILE;             // kOnce: the lo parts of sQ and sDO
  float* sDOlo = sQlo + 2 * TILE;
  float* sStat = sDO + (kOnce ? 6 : 2) * TILE;   // [2 stages][lse, Δ][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const float* qb = slice<float>(q, b, h);
  const float* dob = slice<float>(dout, b, h);
  int qt_lo, qt_hi;
  // The key tile in the queries' frame: the mask depends on q - k alone, so the offset
  // moves the keys and the query tiles keep their own positions.
  const int kq0 = k0 - q_offset;
  live_query_tiles(kq0, S, causal, window, &qt_lo, &qt_hi);

  // The query tile qt's rows of Q and dO, and its lse and Δ (16 floats a warp-quarter).
  const auto stage_queries = [&](int st, int qt) {
    cp_tile<D>(sQ + st * TILE, qb, q.ss, qt * kTile);
    cp_tile<D>(sDO + st * TILE, dob, dout.ss, qt * kTile);
    if (threadIdx.x < 32) {
      const int which = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;
      cp_async16(sStat + (2 * st + which) * kTile + c,
                 (which ? delta : lse) + stat + qt * kTile + c);
    }
  };
  cp_tile<D>(sK, slice<float>(k, b, h), k.ss, k0);
  cp_tile<D>(sV, slice<float>(v, b, h), v.ss, k0);
  if (qt_lo < qt_hi) stage_queries(0, qt_lo);
  cp_async_commit();

  const int key = kq0 + 16 * warp + g;      // this thread's rows key and key + 8, shifted
  const float scale2 = scale * kLog2e;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  const OwnRows<D, kOnce> ok(sK, 16 * warp, g, t), ov(sV, 16 * warp, g, t);

  // the stage toggles (tile qt's buffers), so qt_lo is not live in the walk: with it
  // and the hop offset, ptxas spilled dk/dv at D = 64 (f32) and D = 128 (bf16)
  int stage = 1;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    stage ^= 1;
    cp_async_wait_all();
    if constexpr (kOnce) {        // split tile qt where this thread's copies landed
      split_tile<D>(sQ + stage * TILE, sQlo + stage * TILE);
      split_tile<D>(sDO + stage * TILE, sDOlo + stage * TILE);
    }
    __syncthreads();              // tile qt is in, and every warp is done with tile qt - 1
    if (qt + 1 < qt_hi) {
      stage_queries(stage ^ 1, qt + 1);
      cp_async_commit();
    }
    const WalkedTile<D, kOnce> tQ{sQ + stage * TILE, sQlo + stage * TILE};
    const WalkedTile<D, kOnce> tDO{sDO + stage * TILE, sDOlo + stage * TILE};
    const float* tLse = sStat + 2 * stage * kTile;
    const float* tDelta = tLse + kTile;
    const int q0 = qt * kTile;
    const auto tile_passes = [&](auto masked) {
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += 8 * NJ) {   // the tile's queries, 8·NJ at a time
        float s[NJ][4], dp[NJ][4];  // Sᵀ and dPᵀ: rows are keys, columns queries
        tf32_scores<D, NJ>(ok, ov, tQ, tDO, c0, g, t, s, dp);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = c0 + 8 * j + 2 * t;     // this thread's query columns c and c + 1
          const float2 l2 = *reinterpret_cast<const float2*>(tLse + c);
          const float2 d2 = *reinterpret_cast<const float2*>(tDelta + c);
          const float neg_lse2[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
          const float delta_c[2] = {d2.x, d2.y};
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool vis = true;
            if constexpr (decltype(masked)::value)
              vis = visible(q0 + c + (e & 1), key + 8 * (e >> 1), causal, window);
            p[e] = vis ? exp2_approx(fmaf(s[j][e], scale2, neg_lse2[e & 1])) : 0.f;
            ds[e] = p[e] * (dp[j][e] - delta_c[e & 1]);
          }
          const FragA pa = frag_from_scores(p), da = frag_from_scores(ds);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            mma_3xtf32(acc_v[n], pa, tDO.cols(c0 + 8 * j, 8 * n, g, t));
            mma_3xtf32(acc_k[n], da, tQ.cols(c0 + 8 * j, 8 * n, g, t));
          }
        }
      }
    };
    if (tile_interior(q0, kq0, causal, window))
      tile_passes(std::false_type{});
    else
      tile_passes(std::true_type{});
  }
  store_rows_f32<D>(dk, acc_k, b, key + q_offset, S, H, h, t, scale);
  store_rows_f32<D>(dv, acc_v, b, key + q_offset, S, H, h, t, 1.f);
}

// ---------------------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------------------

struct Shape {
  int B, S, H;
  float scale;
  int causal, window, q_offset;
  dim3 grid() const { return dim3(S / kTile, H, B); }
};

// Launches kernel on the shape's grid, first opening its dynamic shared memory past the
// 48 KB default where it needs more.
template <typename... Params, typename... Args>
cudaError_t start(void (*kernel)(Params...), int block, size_t bytes, const Shape& s,
                  cudaStream_t stream, Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<s.grid(), block, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// bf16 operands take the bf16 tensor-core kernels, f32 ones the 3xTF32 ones.
template <typename T, int D>
cudaError_t launch_fwd(Operand q, Operand k, Operand v, void* out, float* lse, Shape s,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return start(flash_fwd_mma_kernel<D>, kMmaThreads, 5 * mma_tile_bytes<D>(), s, stream, q,
                 k, v, static_cast<bf16*>(out), lse, s.S, s.H, s.scale, s.causal, s.window,
                 s.q_offset);
  else
    return start(flash_fwd_tf32_kernel<D>, kMmaThreads, tf32_fwd_bytes<D>(), s, stream, q, k,
                 v, static_cast<float*>(out), lse, s.S, s.H, s.scale, s.causal, s.window,
                 s.q_offset);
}

template <typename T, int D>
cudaError_t launch_dq(Operand q, Operand k, Operand v, Operand dout, const float* lse,
                      const float* delta, void* dq, Shape s, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return start(flash_dq_mma_kernel<D>, kMmaThreads, 6 * mma_tile_bytes<D>(), s, stream, q,
                 k, v, dout, lse, delta, static_cast<bf16*>(dq), s.S, s.H, s.scale, s.causal,
                 s.window, s.q_offset);
  else
    return start(flash_dq_tf32_kernel<D>, kMmaThreads, tf32_dq_bytes<D>(), s, stream, q, k, v,
                 dout, lse, delta, static_cast<float*>(dq), s.S, s.H, s.scale, s.causal,
                 s.window, s.q_offset);
}

template <typename T, int D>
cudaError_t launch_dkv(Operand q, Operand k, Operand v, Operand dout, const float* lse,
                       const float* delta, void* dk, void* dv, Shape s, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return start(flash_dkv_mma_kernel<D>, kMmaThreads,
                 6 * mma_tile_bytes<D>() + 4 * kTile * sizeof(float), s, stream, q, k, v, dout,
                 lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.S, s.H, s.scale,
                 s.causal, s.window, s.q_offset);
  else
    return start(flash_dkv_tf32_kernel<D>, kMmaThreads, tf32_dkv_bytes<D>(), s, stream, q, k,
                 v, dout, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), s.S,
                 s.H, s.scale, s.causal, s.window, s.q_offset);
}

// Calls fn.template run<T, D>() for the run-time dtype code and head width.
template <typename Fn>
cudaError_t dispatch(int dtype, int d, const Fn& fn) {
  const bool is_bf16 = dtype == kBF16;
  if (!is_bf16 && dtype != kF32) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return is_bf16 ? fn.template run<bf16, 16>() : fn.template run<float, 16>();
    case 64: return is_bf16 ? fn.template run<bf16, 64>() : fn.template run<float, 64>();
    case 128: return is_bf16 ? fn.template run<bf16, 128>() : fn.template run<float, 128>();
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
// 64 and D one of 16, 64, 128 (the wrapper checks both). q_offset: the query positions sit
// q_offset past the keys' origin in the masks (a ring hop's delta·C, any sign).
int flash_fwd(int dtype, const void* q, const int64_t* q_strides, const void* k,
              const int64_t* k_strides, const void* v, const int64_t* v_strides, void* out,
              float* lse, int B, int S, int H, int D, float scale, int causal, int window,
              int q_offset, cudaStream_t stream) {
  const Fwd fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides), out, lse,
               Shape{B, S, H, scale, causal, window, q_offset}, stream};
  return dispatch(dtype, D, fn);
}

// As flash_fwd, plus dout (strided like q) and the f32 [B, H, S] statistics lse and delta;
// dq is contiguous [B, S, H, D].
int flash_dq(int dtype, const void* q, const int64_t* q_strides, const void* k,
             const int64_t* k_strides, const void* v, const int64_t* v_strides, const void* dout,
             const int64_t* dout_strides, const float* lse, const float* delta, void* dq, int B,
             int S, int H, int D, float scale, int causal, int window, int q_offset,
             cudaStream_t stream) {
  const Dq fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides),
              operand(dout, dout_strides), lse, delta, dq,
              Shape{B, S, H, scale, causal, window, q_offset}, stream};
  return dispatch(dtype, D, fn);
}

// As flash_dq, writing dk and dv (contiguous [B, S, H, D]).
int flash_dkv(int dtype, const void* q, const int64_t* q_strides, const void* k,
              const int64_t* k_strides, const void* v, const int64_t* v_strides, const void* dout,
              const int64_t* dout_strides, const float* lse, const float* delta, void* dk,
              void* dv, int B, int S, int H, int D, float scale, int causal, int window,
              int q_offset, cudaStream_t stream) {
  const Dkv fn{operand(q, q_strides), operand(k, k_strides), operand(v, v_strides),
               operand(dout, dout_strides), lse, delta, dk, dv,
               Shape{B, S, H, scale, causal, window, q_offset}, stream};
  return dispatch(dtype, D, fn);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
