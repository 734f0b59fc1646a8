// Blockwise int8 quantization of optimizer state for Hopper (sm_90a):
// quantize, dequantize and the fused quantized-AdamW step.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/quantization.py:
//   quantize   <- _quantize_tiles -> _quant_kernel    (codes + row scales)
//   dequantize <- _dequantize_tiles -> _dequant_kernel (codes x scale)
//   qadam      <- fused_qadam_step -> _qadam_kernel    (dequantize both
//                 moments, AdamW, requantize, update the parameter)
//
// What bounds them on an H100: bytes, in the data-sheet sense.  Each
// does a few dozen flops per element it moves (qadam: ~30 per 10 bytes
// at bf16), far under the card's ~20 flop/byte fp32 balance point, so
// the least time is the bytes over 3.35 TB/s.  Nothing is reread: a row
// is read once into registers, reduced, and written once.  qadam runs
// well above that bound, and what was measured points at its
// instruction issue rather than its loads (see qadam_kernel).
//
// Design, against the TPU kernels:
//  * The TPU kernels walk a sequential grid of 128-row tiles in VMEM.
//    Here quantize and dequantize give one CTA of 256 threads one row
//    of `block` elements (the unit that shares a scale); thread t holds
//    elements t, t+256, ... in registers (8 of them at the default
//    block of 2048, up to 32), so a row is read once, reduced in
//    registers, and written once.  A longer row (block > 8192) does not
//    fit the registers: quantize_long_kernel and qadam_long_kernel take
//    two passes over it, the row's absmax first, then the codes (qadam
//    recomputes the moments from its unchanged inputs in the second
//    pass before anything is written in place).  dequantize_kernel
//    loops over a row of any length.  The row absmax is a warp-shuffle
//    max, then one pass over the eight warps' maxima in shared memory.
//  * qadam runs once for all the 8-bit leaves of a parameter group: a
//    table on the device lists each leaf's tensors, element count,
//    first row and bias corrections, and the threads of a row find its
//    leaf by a binary search over the first rows.  Each thread owns
//    chunks of 8 consecutive elements read and written with 16-byte
//    (g, p) and 8-byte (codes) accesses; |mu| and sqrt(nu) are reduced
//    by warp shuffles, and through shared memory where a row spans the
//    CTA (qadam_kernel).  A chunk that a ragged last row cuts, or whose
//    storage is not aligned, takes a scalar path inside the kernel.
//  * Tensors are read in place from their flat storage: element i of
//    row r is flat[r * block + i], and positions at or past numel read
//    as zero, which is what the reference's zero padding holds.  g and
//    p are read in their own dtype (bf16 or fp32) and upcast in
//    registers, so no padded fp32 copy of them is made.
//  * qadam writes the new parameter in place instead of an update
//    tensor: p_new = round_p(p + round_p(upd)), the value the
//    reference's update gives after optax.apply_updates, without the
//    update buffer.  Codes and scales are rewritten in place too: every
//    lane has read its codes and the row's scales before the row's
//    shuffles, whose results the new codes and scales depend on.
//  * Rounding is the reference's, one rounding per operation: products
//    and sums are __fmul_rn / __fadd_rn, so nvcc cannot contract them
//    into FMAs; x / scale is an IEEE division (__fdiv_rn) and sqrt an
//    IEEE square root (__fsqrt_rn); rounding to an integer is rintf,
//    half to even as jnp.round (qadam's codes take x * fp32(1 / scale)
//    and fall back to the IEEE quotient wherever the two could round
//    to different integers: encode_fast).  The division of a row's absmax by the
//    constant qmax is a product with fp32(1 / qmax), as the reference's
//    XLA rewrites it.  The fp32 constants (b1, 1 - b1, ...) come from
//    the host, each a double rounded once.
//  * Nothing is allocated here and nothing synchronises: each entry
//    launches on the caller's stream and returns cudaGetLastError().
//
// Split-block mode (a shard of a tensor whose global blocks other ranks
// share, e.g. a column-parallel weight under tensor parallelism): the
// shard's flat storage is cut into pieces, each a run of elements that
// lies in one global block, whose scale is row `row` of the shard's
// state.  Codes sit at the element's own flat position.  A row's scale
// needs the absmax over every rank's part of its block, so each kernel
// takes two launches with a max all-reduce between them (made by the
// caller): piece_absmax / qadam_piece_absmax add each piece's absmax
// into amax[row] (atomicMax over the bits of a non-negative float), and
// piece_quantize / qadam_piece_apply encode from the reduced absmax.
// qadam_piece_apply recomputes the moments from the unchanged inputs,
// as qadam_long_kernel's second pass does, and writes the new scales to
// a separate buffer, since other pieces of a row still read the old
// scale.  One CTA a piece, its threads strided over the piece.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One leaf of a multi-tensor launch.  Mirrored by LEAF_DTYPE (a numpy
// structured dtype) in ops/quantization.py.
struct QAdamLeaf {
  void* p;
  const void* g;
  void* q_mu;
  void* mu_scales;
  void* q_nu;
  void* nu_scales;
  long long numel;
  long long row0;  // the leaf's first row among the launch's rows
  float bc1, bc2;  // bias corrections: the step count is per parameter
  int dtype;       // of p and g: 0 float32, 1 bfloat16
  int pad;
};

// One launch of the fused step: every 8-bit leaf of one parameter group,
// with the hyperparameters they share.  Mirrored field for field by
// ctypes in ops/quantization.py.
struct QAdamParams {
  const void* leaves;  // QAdamLeaf[n_leaves] on the device, by row0
  long long n_leaves;
  long long rows;  // of all the leaves
  int block;
  int pad;
  float b1, b2, one_minus_b1, one_minus_b2, neg_lr, eps, wd;
};

// One piece of a split-block launch: `len` elements of a shard's flat
// storage from `start` on, all in the global block whose scale is row
// `row` of the shard's state.  Mirrored by PIECE_DTYPE.
struct Piece {
  long long start;
  int len;
  int row;
};

// One leaf of a split-block q-AdamW launch.  Mirrored by ctypes in
// ops/quantization.py.
struct QAdamSplit {
  void* p;
  const void* g;
  void* q_mu;
  const void* mu_scales;  // old scales, read
  void* q_nu;
  const void* nu_scales;
  const void* pieces;  // Piece[n_pieces] on the device
  long long n_pieces;
  void* amax;  // [rows][2]: |mu| and sqrt(nu) maxima
  void* new_mu_scales;
  void* new_nu_scales;
  float bc1, bc2;
  int dtype;  // of p and g: 0 float32, 1 bfloat16
  int pad;
};

namespace {

constexpr int kThreads = 256;
// quantize and qadam hold a row in registers up to here, and take two
// passes over a longer one
constexpr int kMaxRegBlock = 32 * kThreads;
constexpr int kWarps = kThreads / 32;
constexpr float kScaleFloor = 1e-12f;
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Row maxima of two values across the CTA; every thread gets both.
// Ends with a barrier, so shared memory is free again afterwards.
__device__ __forceinline__ void block_max2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  a = warp_max(a);
  b = warp_max(b);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a = fmaxf(a, sa[w]);
    b = fmaxf(b, sb[w]);
  }
}

// q = clip(rint(x / scale), lo, hi)
__device__ __forceinline__ int8_t encode(float x, float scale, float lo,
                                         float hi) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, lo), hi));
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, long long numel, int block,
                    float qmax, float inv_qmax, int8_t* __restrict__ q,
                    float* __restrict__ scales) {
  const long long row0 = static_cast<long long>(blockIdx.x) * block;
  float v[VPT];
  float absmax = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const long long e = row0 + i;
    v[j] = (i < block && e < numel) ? to_float(x[e]) : 0.0f;
    absmax = fmaxf(absmax, fabsf(v[j]));
  }
  float unused = 0.0f;
  block_max2(absmax, unused);
  const float scale = fmaxf(__fmul_rn(absmax, inv_qmax), kScaleFloor);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < block) q[row0 + i] = encode(v[j], scale, -qmax, qmax);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// A row longer than the registers hold (block > kMaxRegBlock): the absmax
// in a first pass over the row, the codes in a second, both strided by
// the CTA's threads.  The same values and roundings as quantize_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_long_kernel(const T* __restrict__ x, long long numel, int block,
                         float qmax, float inv_qmax, int8_t* __restrict__ q,
                         float* __restrict__ scales) {
  const long long row0 = static_cast<long long>(blockIdx.x) * block;
  float absmax = 0.0f;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const long long e = row0 + i;
    if (e < numel) absmax = fmaxf(absmax, fabsf(to_float(x[e])));
  }
  float unused = 0.0f;
  block_max2(absmax, unused);
  const float scale = fmaxf(__fmul_rn(absmax, inv_qmax), kScaleFloor);
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const long long e = row0 + i;
    const float v = e < numel ? to_float(x[e]) : 0.0f;
    q[row0 + i] = encode(v, scale, -qmax, qmax);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, long long numel,
                      int block, float* __restrict__ out) {
  const long long row0 = static_cast<long long>(blockIdx.x) * block;
  const float scale = scales[blockIdx.x];
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const long long e = row0 + i;
    if (e < numel) out[e] = __fmul_rn(static_cast<float>(q[e]), scale);
  }
}

// ---------------------------------------------------------------------------
// The fused q-AdamW step over many leaves in one launch.  Each row of
// `block` elements (the unit that shares a scale) belongs to TPR threads
// and each thread owns C chunks of 8 consecutive elements: one 16-byte
// load of g and one of p (two each in fp32), one 8-byte load of each code
// array, stores alike.  Rows of up to 256 elements belong to 8, 16 or 32
// lanes of one warp (several rows a warp), and their maxima are warp
// shuffles with no barrier.  A longer row belongs to the whole CTA, one
// chunk a thread up to 2048 elements (C = 1; 2 or 4 above), and its
// maxima take one pass through shared memory (block_max2).  A warp a
// row of 2048 would hold 64 new moments of each kind a lane between the
// maxima and the codes: ~200 registers, 8 warps an SM, too few to keep
// the loads in flight.  One chunk a thread keeps the moments in ~16
// registers and the SM full of warps, which hide each other's barrier.
// On an H100 this kernel behaves as bound by its instruction issue, not
// by its bytes or its load latency: fp32 rows move 1.6x the bytes of
// bf16 ones in 1.1x the time, and a persistent grid that streamed the
// next chunk through a cp.async ring in shared memory ran slower.  Which
// instructions take the issue slots is an inference, not a count: the
// IEEE division and square-root sequences are the longest per element.
// ---------------------------------------------------------------------------

constexpr int kQThreads = kThreads;

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// 8 codes times the row's scale
__device__ __forceinline__ void decode8(const int8_t* src, float scale,
                                        float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t w = k < 4 ? u.x : u.y;
    const int8_t q = static_cast<int8_t>((w >> (8 * (k & 3))) & 0xffu);
    v[k] = __fmul_rn(static_cast<float>(q), scale);
  }
}

// encode() without a division where it cannot change the code: x * inv
// (inv = fp32(1 / scale)) is within 3 ulp of fp32(x / scale), and
// |x / scale| <= 128, so the two round to the same integer unless the
// product lies within 2^-12 of a half-integer; there the IEEE quotient
// is taken.
__device__ __forceinline__ int8_t encode_fast(float x, float scale,
                                              float inv, float lo, float hi) {
  const float y = __fmul_rn(x, inv);
  float q = rintf(y);
  // y - q is exact (Sterbenz), and over 0.5 - 2^-12 just near a tie
  if (fabsf(y - q) > 0.5f - 0x1p-12f) q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, lo), hi));
}

// The AdamW step of one element on its dequantized moments m0 and s0
// (sqrt(nu)), in the reference's order, one rounding per operation:
//   nu = b2 * s0 * s0 + (1 - b2) * g * g;  m = b1 * m0 + (1 - b1) * g
//   upd = -lr * (m / bc1 / (sqrt(nu / bc2) + eps) + wd * p)
__device__ __forceinline__ void adam_elem(const QAdamParams& h,
                                          const QAdamLeaf& L, float gv,
                                          float pv, float m0, float s0,
                                          float& m, float& nsq, float& upd) {
  const float nu = __fadd_rn(__fmul_rn(__fmul_rn(h.b2, s0), s0),
                             __fmul_rn(__fmul_rn(h.one_minus_b2, gv), gv));
  m = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.one_minus_b1, gv));
  const float m_hat = __fdiv_rn(m, L.bc1);
  const float v_hat = __fdiv_rn(nu, L.bc2);
  const float adam = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  upd = __fmul_rn(h.neg_lr, __fadd_rn(adam, __fmul_rn(h.wd, pv)));
  nsq = __fsqrt_rn(nu);
}

// Elements e0 .. e0 + 7 of a leaf (e0 = row * block + 8 c, `left` of the
// row's elements from e0 on): the new mu and sqrt(nu) into m and s (0
// past the row's end), and, if WRITE, the new parameter stored as
// p + round_p(upd) in p's dtype.  Vector accesses where the chunk lies whole in the row
// and in the leaf and its addresses are aligned; else element by element
// (a ragged last row, storage off 16 bytes).
template <typename T, bool WRITE = true>
__device__ __forceinline__ void chunk_step(const QAdamParams& h,
                                           const QAdamLeaf& L, long long e0,
                                           int left, float mu_s, float nu_s,
                                           float (&m)[8], float (&s)[8]) {
  T* p = static_cast<T*>(L.p) + e0;
  const T* g = static_cast<const T*>(L.g) + e0;
  const int8_t* qm = static_cast<const int8_t*>(L.q_mu) + e0;
  const int8_t* qn = static_cast<const int8_t*>(L.q_nu) + e0;
  const bool vec =
      left >= 8 && e0 + 8 <= L.numel &&
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)) &
       15) == 0 &&
      ((reinterpret_cast<uintptr_t>(qm) | reinterpret_cast<uintptr_t>(qn)) &
       7) == 0;
  float gv[8], pv[8], m0[8], s0[8], upd[8];
  if (vec) {
    load8(g, gv);
    load8(p, pv);
    decode8(qm, mu_s, m0);
    decode8(qn, nu_s, s0);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in_row = k < left, inside = in_row && e0 + k < L.numel;
      gv[k] = inside ? to_float(g[k]) : 0.0f;
      pv[k] = inside ? to_float(p[k]) : 0.0f;
      m0[k] = in_row ? __fmul_rn(static_cast<float>(qm[k]), mu_s) : 0.0f;
      s0[k] = in_row ? __fmul_rn(static_cast<float>(qn[k]), nu_s) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    adam_elem(h, L, gv[k], pv[k], m0[k], s0[k], m[k], s[k], upd[k]);
    if (k >= left) m[k] = s[k] = 0.0f;
  }
  if constexpr (!WRITE) return;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    pv[k] = __fadd_rn(pv[k], to_float(from_float<T>(upd[k])));
  if (vec) {
    store8(p, pv);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < left && e0 + k < L.numel) p[k] = from_float<T>(pv[k]);
  }
}

// codes of the chunk from its new moments and the row's new scales
__device__ __forceinline__ void encode_chunk(int8_t* qm, int8_t* qn,
                                             const float (&m)[8],
                                             const float (&s)[8], int left,
                                             float mu_scale, float mu_inv,
                                             float nu_scale, float nu_inv) {
  int8_t cm[8], cn[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cm[k] = encode_fast(m[k], mu_scale, mu_inv, -127.0f, 127.0f);
    cn[k] = encode_fast(s[k], nu_scale, nu_inv, 0.0f, 127.0f);
  }
  if (left >= 8 &&
      ((reinterpret_cast<uintptr_t>(qm) | reinterpret_cast<uintptr_t>(qn)) &
       7) == 0) {
    uint2 um = make_uint2(0u, 0u), un = make_uint2(0u, 0u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t bm = static_cast<uint32_t>(static_cast<uint8_t>(cm[k]))
                         << (8 * (k & 3));
      const uint32_t bn = static_cast<uint32_t>(static_cast<uint8_t>(cn[k]))
                         << (8 * (k & 3));
      if (k < 4) {
        um.x |= bm;
        un.x |= bn;
      } else {
        um.y |= bm;
        un.y |= bn;
      }
    }
    *reinterpret_cast<uint2*>(qm) = um;
    *reinterpret_cast<uint2*>(qn) = un;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < left) {
        qm[k] = cm[k];
        qn[k] = cn[k];
      }
  }
}

// the leaf of a row: the last whose first row is at or before it
__device__ __forceinline__ int find_leaf(const QAdamParams& h,
                                         const QAdamLeaf* leaves,
                                         long long row) {
  int leaf = 0, hi = static_cast<int>(h.n_leaves) - 1;
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (__ldg(&leaves[mid].row0) <= row) {
      leaf = mid;
    } else {
      hi = mid - 1;
    }
  }
  return leaf;
}

template <int TPR, int C>
__global__ void __launch_bounds__(kQThreads, C == 1 ? 4 : 1)
    qadam_kernel(const QAdamParams h) {
  static_assert(TPR <= 32 || TPR == kQThreads, "qadam: a row's threads");
  const int sub = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kQThreads / TPR) +
      threadIdx.x / TPR;
  const bool active = row < h.rows;
  const QAdamLeaf* leaves = static_cast<const QAdamLeaf*>(h.leaves);
  const QAdamLeaf L = leaves[active ? find_leaf(h, leaves, row) : 0];
  const long long r = row - L.row0;
  const int block = h.block, n_chunks = (block + 7) / 8;
  float* mu_scales = static_cast<float*>(L.mu_scales);
  float* nu_scales = static_cast<float*>(L.nu_scales);
  const float mu_s = active ? mu_scales[r] : 0.0f;
  const float nu_s = active ? nu_scales[r] : 0.0f;
  const bool bf16 = L.dtype == 1;

  // every thread reaches the reduction below, so rows of other dtypes (or
  // none) take the branches, never a return
  float m[C][8], s[C][8];
  float mu_max = 0.0f, nu_max = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = j * TPR + sub;
    if (!active || c >= n_chunks) continue;
    const long long e0 = r * block + 8 * c;
    if (bf16) {
      chunk_step<__nv_bfloat16>(h, L, e0, block - 8 * c, mu_s, nu_s, m[j],
                                s[j]);
    } else {
      chunk_step<float>(h, L, e0, block - 8 * c, mu_s, nu_s, m[j], s[j]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mu_max = fmaxf(mu_max, fabsf(m[j][k]));
      nu_max = fmaxf(nu_max, s[j][k]);
    }
  }
  if constexpr (TPR == kQThreads) {
    block_max2(mu_max, nu_max);
  } else {
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) {
      mu_max = fmaxf(mu_max, __shfl_xor_sync(0xffffffffu, mu_max, o));
      nu_max = fmaxf(nu_max, __shfl_xor_sync(0xffffffffu, nu_max, o));
    }
  }
  if (!active) return;
  const float mu_scale = fmaxf(__fmul_rn(mu_max, kInv127), kScaleFloor);
  const float nu_scale = fmaxf(__fmul_rn(nu_max, kInv127), kScaleFloor);
  const float mu_inv = __frcp_rn(mu_scale), nu_inv = __frcp_rn(nu_scale);
  int8_t* q_mu = static_cast<int8_t*>(L.q_mu);
  int8_t* q_nu = static_cast<int8_t*>(L.q_nu);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = j * TPR + sub;
    if (c >= n_chunks) continue;
    const long long e0 = r * block + 8 * c;
    encode_chunk(q_mu + e0, q_nu + e0, m[j], s[j], block - 8 * c, mu_scale,
                 mu_inv, nu_scale, nu_inv);
  }
  if (sub == 0) {
    mu_scales[r] = mu_scale;
    nu_scales[r] = nu_scale;
  }
}

// A row longer than the registers hold (block > kMaxRegBlock): one CTA a
// row and two passes over it.  The first computes each chunk's new
// moments for the row's maxima and writes nothing; the second recomputes
// them from the same, still unchanged, inputs, writes the parameter and
// encodes the codes.  A chunk is read and written by one thread, and the
// old scales are read before the first pass, so the in-place writes
// race with no read.
__global__ void __launch_bounds__(kQThreads)
    qadam_long_kernel(const QAdamParams h) {
  const long long row = blockIdx.x;
  const QAdamLeaf* leaves = static_cast<const QAdamLeaf*>(h.leaves);
  const QAdamLeaf L = leaves[find_leaf(h, leaves, row)];
  const long long r = row - L.row0;
  const int block = h.block, n_chunks = (block + 7) / 8;
  float* mu_scales = static_cast<float*>(L.mu_scales);
  float* nu_scales = static_cast<float*>(L.nu_scales);
  const float mu_s = mu_scales[r], nu_s = nu_scales[r];
  const bool bf16 = L.dtype == 1;
  float mu_max = 0.0f, nu_max = 0.0f;
  for (int c = threadIdx.x; c < n_chunks; c += kQThreads) {
    const long long e0 = r * block + 8 * c;
    float m[8], s[8];
    if (bf16) {
      chunk_step<__nv_bfloat16, false>(h, L, e0, block - 8 * c, mu_s, nu_s,
                                       m, s);
    } else {
      chunk_step<float, false>(h, L, e0, block - 8 * c, mu_s, nu_s, m, s);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mu_max = fmaxf(mu_max, fabsf(m[k]));
      nu_max = fmaxf(nu_max, s[k]);
    }
  }
  block_max2(mu_max, nu_max);
  const float mu_scale = fmaxf(__fmul_rn(mu_max, kInv127), kScaleFloor);
  const float nu_scale = fmaxf(__fmul_rn(nu_max, kInv127), kScaleFloor);
  const float mu_inv = __frcp_rn(mu_scale), nu_inv = __frcp_rn(nu_scale);
  int8_t* q_mu = static_cast<int8_t*>(L.q_mu);
  int8_t* q_nu = static_cast<int8_t*>(L.q_nu);
  for (int c = threadIdx.x; c < n_chunks; c += kQThreads) {
    const long long e0 = r * block + 8 * c;
    float m[8], s[8];
    if (bf16) {
      chunk_step<__nv_bfloat16>(h, L, e0, block - 8 * c, mu_s, nu_s, m, s);
    } else {
      chunk_step<float>(h, L, e0, block - 8 * c, mu_s, nu_s, m, s);
    }
    encode_chunk(q_mu + e0, q_nu + e0, m, s, block - 8 * c, mu_scale, mu_inv,
                 nu_scale, nu_inv);
  }
  if (threadIdx.x == 0) {
    mu_scales[r] = mu_scale;
    nu_scales[r] = nu_scale;
  }
}

template <int TPR, int C>
int launch_qadam(const QAdamParams* h, cudaStream_t stream) {
  constexpr long long per_cta = kQThreads / TPR;
  const long long grid = (h->rows + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qadam_kernel<TPR, C>
      <<<static_cast<unsigned>(grid), kQThreads, 0, stream>>>(*h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VPT>
void launch_quantize(const void* x, long long numel, long long rows,
                     int block, float qmax, float inv_qmax, void* q,
                     void* scales, cudaStream_t stream) {
  quantize_kernel<T, VPT><<<static_cast<unsigned>(rows), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(x), numel, block, qmax, inv_qmax,
      static_cast<int8_t*>(q), static_cast<float*>(scales));
}

template <typename T>
int quantize_dispatch(const void* x, long long numel, long long rows,
                      int block, float qmax, float inv_qmax, void* q,
                      void* scales, cudaStream_t stream) {
  if (block <= 8 * kThreads) {
    launch_quantize<T, 8>(x, numel, rows, block, qmax, inv_qmax, q, scales,
                          stream);
  } else if (block <= kMaxRegBlock) {
    launch_quantize<T, 32>(x, numel, rows, block, qmax, inv_qmax, q,
                           scales, stream);
  } else {
    quantize_long_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                              stream>>>(
        static_cast<const T*>(x), numel, block, qmax, inv_qmax,
        static_cast<int8_t*>(q), static_cast<float*>(scales));
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Split-block mode (see the header): one CTA a piece.
// ---------------------------------------------------------------------------

// amax[i] = max(amax[i], v) for v >= 0: the order of non-negative floats
// is the order of their bits as ints
__device__ __forceinline__ void atomic_max_nonneg(float* a, float v) {
  atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    piece_absmax_kernel(const T* __restrict__ x,
                        const Piece* __restrict__ pieces,
                        float* __restrict__ amax) {
  const Piece pc = pieces[blockIdx.x];
  float m = 0.0f;
  for (int i = threadIdx.x; i < pc.len; i += kThreads)
    m = fmaxf(m, fabsf(to_float(x[pc.start + i])));
  float unused = 0.0f;
  block_max2(m, unused);
  if (threadIdx.x == 0) atomic_max_nonneg(&amax[pc.row], m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    piece_quantize_kernel(const T* __restrict__ x,
                          const Piece* __restrict__ pieces,
                          const float* __restrict__ amax, float qmax,
                          float inv_qmax, int8_t* __restrict__ q,
                          float* __restrict__ scales) {
  const Piece pc = pieces[blockIdx.x];
  const float scale = fmaxf(__fmul_rn(amax[pc.row], inv_qmax), kScaleFloor);
  for (int i = threadIdx.x; i < pc.len; i += kThreads)
    q[pc.start + i] = encode(to_float(x[pc.start + i]), scale, -qmax, qmax);
  // every piece of the row writes the same value
  if (threadIdx.x == 0) scales[pc.row] = scale;
}

__global__ void __launch_bounds__(kThreads)
    piece_dequantize_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            const Piece* __restrict__ pieces,
                            float* __restrict__ out) {
  const Piece pc = pieces[blockIdx.x];
  const float scale = scales[pc.row];
  for (int i = threadIdx.x; i < pc.len; i += kThreads)
    out[pc.start + i] = __fmul_rn(static_cast<float>(q[pc.start + i]), scale);
}

// element e's new mu and sqrt(nu), and its update, from the old codes and
// the old scales of its row
template <typename T>
__device__ __forceinline__ void split_elem(const QAdamParams& h,
                                           const QAdamLeaf& L,
                                           const QAdamSplit& S, long long e,
                                           float mu_s, float nu_s, float& m,
                                           float& nsq, float& upd,
                                           float& pv) {
  const float gv = to_float(static_cast<const T*>(S.g)[e]);
  pv = to_float(static_cast<const T*>(S.p)[e]);
  const float m0 =
      __fmul_rn(static_cast<float>(static_cast<const int8_t*>(S.q_mu)[e]),
                mu_s);
  const float s0 =
      __fmul_rn(static_cast<float>(static_cast<const int8_t*>(S.q_nu)[e]),
                nu_s);
  adam_elem(h, L, gv, pv, m0, s0, m, nsq, upd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qadam_piece_absmax_kernel(const QAdamParams h, const QAdamSplit S) {
  const Piece pc = static_cast<const Piece*>(S.pieces)[blockIdx.x];
  QAdamLeaf L{};
  L.bc1 = S.bc1;
  L.bc2 = S.bc2;
  const float mu_s = static_cast<const float*>(S.mu_scales)[pc.row];
  const float nu_s = static_cast<const float*>(S.nu_scales)[pc.row];
  float mu_max = 0.0f, nu_max = 0.0f;
  for (int i = threadIdx.x; i < pc.len; i += kThreads) {
    float m, nsq, upd, pv;
    split_elem<T>(h, L, S, pc.start + i, mu_s, nu_s, m, nsq, upd, pv);
    mu_max = fmaxf(mu_max, fabsf(m));
    nu_max = fmaxf(nu_max, nsq);
  }
  block_max2(mu_max, nu_max);
  if (threadIdx.x == 0) {
    float* amax = static_cast<float*>(S.amax);
    atomic_max_nonneg(&amax[2 * pc.row], mu_max);
    atomic_max_nonneg(&amax[2 * pc.row + 1], nu_max);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qadam_piece_apply_kernel(const QAdamParams h, const QAdamSplit S) {
  const Piece pc = static_cast<const Piece*>(S.pieces)[blockIdx.x];
  QAdamLeaf L{};
  L.bc1 = S.bc1;
  L.bc2 = S.bc2;
  const float mu_s = static_cast<const float*>(S.mu_scales)[pc.row];
  const float nu_s = static_cast<const float*>(S.nu_scales)[pc.row];
  const float* amax = static_cast<const float*>(S.amax);
  const float mu_scale = fmaxf(__fmul_rn(amax[2 * pc.row], kInv127),
                               kScaleFloor);
  const float nu_scale = fmaxf(__fmul_rn(amax[2 * pc.row + 1], kInv127),
                               kScaleFloor);
  const float mu_inv = __frcp_rn(mu_scale), nu_inv = __frcp_rn(nu_scale);
  T* p = static_cast<T*>(S.p);
  int8_t* q_mu = static_cast<int8_t*>(S.q_mu);
  int8_t* q_nu = static_cast<int8_t*>(S.q_nu);
  for (int i = threadIdx.x; i < pc.len; i += kThreads) {
    const long long e = pc.start + i;
    float m, nsq, upd, pv;
    split_elem<T>(h, L, S, e, mu_s, nu_s, m, nsq, upd, pv);
    p[e] = from_float<T>(__fadd_rn(pv, to_float(from_float<T>(upd))));
    q_mu[e] = encode_fast(m, mu_scale, mu_inv, -127.0f, 127.0f);
    q_nu[e] = encode_fast(nsq, nu_scale, nu_inv, 0.0f, 127.0f);
  }
  if (threadIdx.x == 0) {
    static_cast<float*>(S.new_mu_scales)[pc.row] = mu_scale;
    static_cast<float*>(S.new_nu_scales)[pc.row] = nu_scale;
  }
}

int check_pieces(long long n_pieces) {
  return (n_pieces <= 0 || n_pieces > 0x7fffffffLL)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

extern "C" {

int dlr_quantize(const void* x, int dtype, long long numel, long long rows,
                 int block, float qmax, float inv_qmax, void* q,
                 void* scales, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return quantize_dispatch<__nv_bfloat16>(x, numel, rows, block, qmax,
                                            inv_qmax, q, scales, s);
  }
  return quantize_dispatch<float>(x, numel, rows, block, qmax, inv_qmax, q,
                                  scales, s);
}

int dlr_dequantize(const void* q, const void* scales, long long numel,
                   long long rows, int block, void* out, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dequantize_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      numel, block, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int dlr_qadam_step(const QAdamParams* p, void* stream) {
  if (p->rows <= 0 || p->n_leaves <= 0 || p->n_leaves > 0x7fffffffLL ||
      p->block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (p->block + 7) / 8;
  if (n_chunks <= 8) return launch_qadam<8, 1>(p, s);
  if (n_chunks <= 16) return launch_qadam<16, 1>(p, s);
  if (n_chunks <= 32) return launch_qadam<32, 1>(p, s);
  if (n_chunks <= kQThreads) return launch_qadam<kQThreads, 1>(p, s);
  if (n_chunks <= 2 * kQThreads) return launch_qadam<kQThreads, 2>(p, s);
  if (p->block <= kMaxRegBlock) return launch_qadam<kQThreads, 4>(p, s);
  if (p->rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qadam_long_kernel<<<static_cast<unsigned>(p->rows), kQThreads, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

int dlr_piece_absmax(const void* x, int dtype, const void* pieces,
                     long long n_pieces, void* amax, void* stream) {
  if (int err = check_pieces(n_pieces)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_pieces);
  const Piece* pc = static_cast<const Piece*>(pieces);
  if (dtype == 1) {
    piece_absmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pc, static_cast<float*>(amax));
  } else {
    piece_absmax_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), pc, static_cast<float*>(amax));
  }
  return static_cast<int>(cudaGetLastError());
}

int dlr_piece_quantize(const void* x, int dtype, const void* pieces,
                       long long n_pieces, const void* amax, float qmax,
                       float inv_qmax, void* q, void* scales, void* stream) {
  if (int err = check_pieces(n_pieces)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_pieces);
  const Piece* pc = static_cast<const Piece*>(pieces);
  const float* a = static_cast<const float*>(amax);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (dtype == 1) {
    piece_quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pc, a, qmax, inv_qmax, qq, sc);
  } else {
    piece_quantize_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), pc, a, qmax, inv_qmax, qq, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

int dlr_piece_dequantize(const void* q, const void* scales,
                         const void* pieces, long long n_pieces, void* out,
                         void* stream) {
  if (int err = check_pieces(n_pieces)) return err;
  piece_dequantize_kernel<<<static_cast<unsigned>(n_pieces), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const Piece*>(pieces), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// pass 0: the moments' maxima into S->amax; pass 1: the codes, the new
// scales and the parameter
int dlr_qadam_split(const QAdamParams* h, const QAdamSplit* S, int pass,
                    void* stream) {
  if (int err = check_pieces(S->n_pieces)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(S->n_pieces);
  const bool bf16 = S->dtype == 1;
  if (pass == 0) {
    if (bf16) {
      qadam_piece_absmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          *h, *S);
    } else {
      qadam_piece_absmax_kernel<float><<<grid, kThreads, 0, s>>>(*h, *S);
    }
  } else if (bf16) {
    qadam_piece_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*h,
                                                                      *S);
  } else {
    qadam_piece_apply_kernel<float><<<grid, kThreads, 0, s>>>(*h, *S);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dlr_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
