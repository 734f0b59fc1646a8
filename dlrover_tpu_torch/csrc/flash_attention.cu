// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   forward  <- _fwd -> _fwd_kernel      (online-softmax forward)
//   dQ       <- _bwd -> _bwd_dq_kernel   (dQ; also writes the row term
//                                         Delta = rowsum(O * dO))
//   dK/dV    <- _bwd -> _bwd_dkv_kernel  (dK and dV)
// each in two versions: bf16 and fp16 at head_dim 64 and 128 on the
// tensor cores (wgmma; bf16 is the training path), and FMA kernels on the
// CUDA cores for fp32 at head_dim 64, 128 and 256 (an exact-check path,
// bound by FMA issue, 67 TFLOP/s, and shared-memory reads) and for bf16
// and fp16 at head_dim 256 (a simple instance: fp32 arithmetic on
// tiles of 32 rows).  The Python wrapper zero-pads every other head_dim
// up to 64, 128 or 256, which leaves QK^T and PV unchanged.
//
// What bounds them on an H100: at GPT-2 shapes (seq 1024, head_dim 64)
// attention does ~250 FLOPs per byte it must move, near the card's
// 295 FLOP/byte balance point of bf16 tensor cores (989 TFLOP/s) and
// HBM (3.35 TB/s).  Inside the SM, head_dim 64 makes the exponentials
// weigh as much as the products: the special-function unit does 16
// exp2 a clock per SM where the tensor cores do ~4096 FLOPs, and each
// score costs one exp2 beside 256 FLOPs of the forward's two products.
// So a fast kernel keeps the tensor cores, the exp2 unit and the copies
// busy at once.  What the designs do about it:
//
//  * The wgmma kernels are written once over the element type T (bf16
//    or fp16): the same shapes, fragments and fp32 accumulators, the
//    PTX type and the TMA maps' data type differ.
//  * bf16 forward (fwd_tma_kernel): persistent, one CTA per SM walking
//    q tiles of 128 rows heaviest first (a snake over the CTAs).  Two
//    consumer warpgroups own 64 rows each (the M of one wgmma); a
//    producer warpgroup gives them its registers (setmaxnreg) and one
//    lane of it issues every TMA copy: Q once per q tile, released
//    after its last product so the next tile's Q loads under this
//    tile's tail, and K and V tiles of 128 rows (64 at head_dim 128)
//    through a four-stage ring (mbarrier full/empty pairs, 128-byte
//    swizzle).  S = Q K^T is a wgmma from shared memory (both K-major);
//    O += P V is a wgmma with P as the register A operand, rounded to
//    bf16 there as the TPU rounds it (p.astype(v.dtype)), and V read
//    MN-major with the transpose flag.  Each warpgroup issues S_j with
//    P_{j-1} V_{j-1} and runs the softmax of S_j beside that product;
//    the two warpgroups take turns to issue (named barriers), so one's
//    softmax runs beside the other's products.  The softmax stays in
//    registers in the log2 domain (one FMA folds scale * log2(e) into
//    exp2's argument; lse is written in natural-log units at the end),
//    and only the diagonal tile and the ragged last tile are masked.
//  * bf16 dK/dV (dkv_tma_kernel): a CTA owns 128 k rows, two consumer
//    warpgroups of 64, loads K and V once and streams Q, dO, lse and
//    Delta tiles of 64 q rows (16 at head_dim 128, for registers)
//    through a two-stage ring, over the q tiles at or past the diagonal
//    and the GQA group's q heads (no atomics, deterministic).
//    S^T = K Q^T and dP^T = V dO^T are wgmmas from shared memory,
//    committed apart so that p^T = exp2(...) is formed while dP^T still
//    runs; dS^T follows.  dV += p^T dO and dK += dS^T Q are register-A
//    wgmmas with dO and Q read MN-major.  The TPU kernel keeps p and dS
//    in fp32, so each is split into a bf16 high part and a bf16
//    remainder (16 significant bits) issued into the same fp32
//    accumulator: six products per tile pair where the bound counts
//    four, all at the wgmma rate.
//  * bf16 dQ (dq_tma_kernel): the forward's shape with one more
//    product.  Persistent, q tiles of 128 rows heaviest first, two
//    consumer warpgroups of 64 rows and a producer warpgroup; Q and dO
//    come by TMA once per q tile, K and V tiles of 64 rows (32 at
//    head_dim 128, for registers) through a four-stage ring.  S = Q K^T
//    and dP = dO V^T are wgmmas from shared memory, committed apart so
//    that p = exp2(...) is formed while dP runs; dS = p (dP - Delta)
//    scale is rounded to bf16 (the TPU's ds.astype(k.dtype)) straight
//    into register A fragments, and dQ += dS K reads K MN-major with
//    the transpose flag, as the forward reads V.  dQ_{j-1} is issued
//    with S_j and dP_j, so the exp2 and dS work of tile j runs beside
//    it.  Delta = rowsum(O dO) is taken per q tile in fp32 with 16-byte
//    loads before the tile's first wait, written for dK/dV, and kept in
//    registers beside -lse log2(e).  Six FLOPs per score where the
//    forward does four, at the same exp2 count.
//  * TMA reads q, k, v and dO through 4-D tensor maps over
//    [b, s, h, d] with the caller's strides (the fused-qkv views are
//    read as they are): a box that runs past seq is zero-filled inside
//    its own batch row.  The maps are encoded on the host for every
//    launch with cuTensorMapEncodeTiled, taken from the driver through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Common to all:
//  * The TPU walks a sequential grid and carries m/l/acc in VMEM
//    scratch across k steps.  Here one CTA owns a q tile (forward, dQ)
//    or a k tile (dK/dV) and loops over the other axis itself, with the
//    accumulators in registers.
//  * Causal: k tiles past the diagonal are skipped (forward, dQ) and q
//    tiles that end before the k tile are skipped (dK/dV).  The ragged
//    last tile of any seq length is masked.
//  * Rounding follows the TPU kernels: the forward rounds p to v's
//    dtype before P.V; dQ rounds dS to k's dtype before dS.K; dK/dV
//    keep p, dS, dO and q in fp32.  Masked scores give p = 0 exactly.
//  * GQA: q head h reads kv head h / group.  The dK/dV CTA loops the
//    group's q heads itself and writes per-kv-head sums.
//  * Nothing is allocated here and nothing synchronises: each entry
//    launches on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

// Mirrored field for field by ctypes in ops/flash_attention.py.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;
  void* lse;
  void* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int B, S, H, KVH, group, causal, dtype, head_dim;
  float scale;
};

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;
using hopper::is_f16;

// Storage types of the FMA kernels (fp32, bf16, fp16) to and from their
// fp32 arithmetic
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else if constexpr (is_f16<T>()) return __float2half_rn(x);
  else return __float2bfloat16_rn(x);
}
// x rounded to T: where the TPU kernels cast to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The FMA kernels' tiles: TM q rows by TM k rows with 256 threads, thread
// (ty, tx) owning rows ty + 16 i and columns tx + 16 j (i, j < TM / 16)
// of each score tile, so a row's 16 owners are one half-warp and row
// max/sum are shuffles.  Shared rows are padded by 4 floats: float4
// reads along head_dim are bank-conflict free.  TM is 64, and 32 at
// head_dim 256, where four 64-row fp32 tiles would not fit shared memory.
template <int D, int TM>
struct Fma {
  static constexpr int kI = TM / 16;   // rows (and columns) a thread owns
  static constexpr int kJ = D / 16;    // head_dim columns a thread owns
  static constexpr int kLd = D + 4;    // row stride of the q/k/v tiles
  static constexpr int kPLd = TM + 4;  // row stride of the score tiles
  static constexpr size_t kTileF = (size_t)TM * kLd;
  static constexpr size_t kScoreF = (size_t)TM * kPLd;
  static constexpr size_t kFwdSmem = sizeof(float) * (3 * kTileF + kScoreF);
  static constexpr size_t kDqSmem =
      sizeof(float) * (4 * kTileF + kScoreF + 2 * TM);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (4 * kTileF + 2 * kScoreF + 2 * TM);
};

// dst[r][c] = base[(row0 + r) * row_stride + c] in fp32, zero past seq
template <int D, int TM, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < TM * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < S ? to_f(base[(long long)row * row_stride + c]) : 0.f;
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c]  (A . B^T)
template <int D, int I>
__device__ __forceinline__ void fma_abt(const float* A, const float* Bm,
                                        float acc[I][I], int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 a[I], b[I];
#pragma unroll
    for (int i = 0; i < I; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < I; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < I; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][jj] += sum_k P[ty + 16 i][k] * M[k][tx + 16 jj]  (P . M)
template <int D, int TM>
__device__ __forceinline__ void fma_pm(const float* P, const float* M,
                                       float acc[TM / 16][D / 16], int ty,
                                       int tx) {
  constexpr int LD = D + 4, PLD = TM + 4, I = TM / 16;
#pragma unroll 2
  for (int k = 0; k < TM; k += 4) {
    float4 p[I];
#pragma unroll
    for (int i = 0; i < I; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * PLD + k);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const float m0 = M[(k + 0) * LD + tx + 16 * jj];
      const float m1 = M[(k + 1) * LD + tx + 16 * jj];
      const float m2 = M[(k + 2) * LD + tx + 16 * jj];
      const float m3 = M[(k + 3) * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        float s = acc[i][jj];
        s = fmaf(p[i].x, m0, s);
        s = fmaf(p[i].y, m1, s);
        s = fmaf(p[i].z, m2, s);
        s = fmaf(p[i].w, m3, s);
        acc[i][jj] = s;
      }
    }
  }
}

// reductions over the 16 lanes (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// The FMA kernels: fp32 (every head_dim), and bf16 and fp16 at head_dim
// 256, on the CUDA cores.  Storage of type T is read into fp32 tiles and
// written back as T; p (forward) and dS (dQ) are rounded to T before
// their products, as the TPU kernels round them, and dK/dV keeps both in
// fp32.
//
// forward: one CTA per (b*H + h, q tile)
// ---------------------------------------------------------------------------

template <int D, int TM, typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const FlashParams p) {
  using F = Fma<D, TM>;
  constexpr int LD = F::kLd, PLD = F::kPLd, I = F::kI, J = F::kJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + TM * LD;
  float* Vs = Ks + TM * LD;
  float* Ps = Vs + TM * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  // heaviest (most k tiles under causal) q tiles start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * TM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D, TM>(Qs, qb, p.q_ss, q0, p.S);

  float m[I], l[I], acc[I][J];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  int n_kt = (p.S + TM - 1) / TM;
  if (p.causal) n_kt = min(n_kt, (q0 + TM - 1) / TM + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TM;
    __syncthreads();  // the last tile's readers are done
    load_tile<D, TM>(Ks, kb, p.k_ss, k0, p.S);
    load_tile<D, TM>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[I][I] = {};
    fma_abt<D, I>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= p.S || (p.causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const float e = expf(s[i][j] - m_new);
        psum += e;
        // p.astype(v.dtype) before P V
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(e);
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    fma_pm<D, TM>(Ps, Vs, acc, ty, tx);
  }

  T* ob = static_cast<T*>(p.out);
  float* lse = static_cast<float*>(p.lse);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      ob[row * D + tx + 16 * jj] = from_f<T>(acc[i][jj] / safe_l);
    if (tx == 0) lse[(long long)bh * p.S + qpos] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b*H + h, q tile); writes Delta for the dK/dV kernel
// ---------------------------------------------------------------------------

template <int D, int TM, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const FlashParams p) {
  using F = Fma<D, TM>;
  constexpr int LD = F::kLd, PLD = F::kPLd, I = F::kI, J = F::kJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + TM * LD;
  float* Ks = dOs + TM * LD;
  float* Vs = Ks + TM * LD;
  float* dSs = Vs + TM * LD;
  float* lse_s = dSs + TM * PLD;
  float* dl_s = lse_s + TM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * TM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* obase = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  load_tile<D, TM>(Qs, qb, p.q_ss, q0, p.S);
  load_tile<D, TM>(dOs, dob, p.do_ss, q0, p.S);
  load_tile<D, TM>(Ks, obase, p.o_ss, q0, p.S);  // O, for Delta only
  __syncthreads();

  // Delta = rowsum(O * dO) in fp32; 4 lanes per row (whole warps of
  // threads past the tile's rows skip it)
  if ((threadIdx.x >> 2) < TM) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float d = 0.f;
    for (int c = part; c < D; c += 4) d += Ks[r * LD + c] * dOs[r * LD + c];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      const int qpos = q0 + r;
      const bool ok = qpos < p.S;
      dl_s[r] = d;
      lse_s[r] =
          ok ? static_cast<const float*>(p.lse)[(long long)bh * p.S + qpos]
             : 0.f;
      if (ok) static_cast<float*>(p.delta)[(long long)bh * p.S + qpos] = d;
    }
  }

  float dq[I][J];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dq[i][jj] = 0.f;

  int n_kt = (p.S + TM - 1) / TM;
  if (p.causal) n_kt = min(n_kt, (q0 + TM - 1) / TM + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TM;
    __syncthreads();
    load_tile<D, TM>(Ks, kb, p.k_ss, k0, p.S);
    load_tile<D, TM>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[I][I] = {}, dp[I][I] = {};
    fma_abt<D, I>(Qs, Ks, s, ty, tx);
    fma_abt<D, I>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok =
            qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
        const float pr = ok ? expf(s[i][j] * p.scale - lse_r) : 0.f;
        const float ds = pr * (dp[i][j] - dl_r) * p.scale;
        dSs[r * PLD + tx + 16 * j] = round_to<T>(ds);  // ds.astype(k.dtype)
      }
    }
    __syncthreads();
    fma_pm<D, TM>(dSs, Ks, dq, ty, tx);
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      dqb[row * D + tx + 16 * jj] = from_f<T>(dq[i][jj]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (b*KVH + kv head, k tile), looping the group's q
// heads and the q tiles at or past the diagonal
// ---------------------------------------------------------------------------

template <int D, int TM, typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const FlashParams p) {
  using F = Fma<D, TM>;
  constexpr int LD = F::kLd, PLD = F::kPLd, I = F::kI, J = F::kJ;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TM * LD;
  float* Qs = Vs + TM * LD;
  float* dOs = Qs + TM * LD;
  float* Ps = dOs + TM * LD;
  float* dSs = Ps + TM * PLD;
  float* lse_s = dSs + TM * PLD;
  float* dl_s = lse_s + TM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / p.KVH, hk = bkv % p.KVH;
  const int k0 = blockIdx.x * TM;

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D, TM>(Ks, kb, p.k_ss, k0, p.S);
  load_tile<D, TM>(Vs, vb, p.v_ss, k0, p.S);

  // rows of dk/dv are k rows ty + 16 i, columns tx + 16 jj
  float dk[I][J], dv[I][J];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int n_qt = (p.S + TM - 1) / TM;
  const int qt0 = p.causal ? k0 / TM : 0;
  const float* lse_g = static_cast<const float*>(p.lse);
  const float* dl_g = static_cast<const float*>(p.delta);

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long bh = (long long)b * p.H + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TM;
      __syncthreads();
      load_tile<D, TM>(Qs, qb, p.q_ss, q0, p.S);
      load_tile<D, TM>(dOs, dob, p.do_ss, q0, p.S);
      if (threadIdx.x < TM) {
        const int qpos = q0 + threadIdx.x;
        const bool ok = qpos < p.S;
        lse_s[threadIdx.x] = ok ? lse_g[bh * p.S + qpos] : 0.f;
        dl_s[threadIdx.x] = ok ? dl_g[bh * p.S + qpos] : 0.f;
      }
      __syncthreads();

      // score tile: rows are q (ty + 16 i), columns are k (tx + 16 j)
      float s[I][I] = {}, dp[I][I] = {};
      fma_abt<D, I>(Qs, Ks, s, ty, tx);
      fma_abt<D, I>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
        const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
        for (int j = 0; j < I; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool ok =
              qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
          const float pr = ok ? expf(s[i][j] * p.scale - lse_r) : 0.f;
          Ps[r * PLD + tx + 16 * j] = pr;
          dSs[r * PLD + tx + 16 * j] = pr * (dp[i][j] - dl_r) * p.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q, all fp32
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
        float pc[I], dsc[I];
#pragma unroll
        for (int i = 0; i < I; ++i) {
          pc[i] = Ps[r * PLD + ty + 16 * i];
          dsc[i] = dSs[r * PLD + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float o = dOs[r * LD + tx + 16 * jj];
          const float qv = Qs[r * LD + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < I; ++i) {
            dv[i][jj] = fmaf(pc[i], o, dv[i][jj]);
            dk[i][jj] = fmaf(dsc[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.S) continue;
    const long long row = ((long long)b * p.S + kpos) * p.KVH + hk;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      dkb[row * D + tx + 16 * jj] = from_f<T>(dk[i][jj]);
      dvb[row * D + tx + 16 * jj] = from_f<T>(dv[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// register helpers of the wgmma kernels below (T is bf16 or fp16).  A
// wgmma accumulator and a register A operand have the mma.sync m16n8k16
// fragment layouts per warp, so packing, the split, C-to-A fragments and
// the quad reductions (the four threads that share a row) work on them
// directly.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (is_f16<T>()) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
}

// x0, x1 as pairs of T: hi = rn(x), lo = rn(x - hi); hi + lo keeps 16
// significant bits in bf16 and 22 in fp16 (less where lo is subnormal)
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  const float2 hf = unpack2<T>(hi);
  lo = pack2<T>(x0 - hf.x, x1 - hf.y);
}

// the C fragments of n tiles 2j and 2j + 1 (cols 2t, 2t + 1 of rows g
// and g + 8) are the A fragment of k step j
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t a[4], int hi, float c0,
                                       float c1, float c2, float c3) {
  a[2 * hi] = pack2<T>(c0, c1);
  a[2 * hi + 1] = pack2<T>(c2, c3);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 and fp16 forward, dK/dV and dQ on wgmma, fed by TMA.
//
// A CTA is three warpgroups: two consumers (warps 0-7), each owning 64
// rows of the CTA's 128-row tile, and a producer (warps 8-11) whose
// first lane issues every copy.  The producer gives its registers to
// the consumers (setmaxnreg: 56 + 2 x 224 of the 512 a lane of each SM
// sub-partition holds).  Streamed tiles pass through a ring of kStages
// stages: the producer waits on a stage's `empty` barrier (one arrival
// per consumer warp), announces the stage's bytes on its `full` barrier
// and issues the copies; the consumers wait on `full`, run their wgmmas
// and arrive on `empty`.
//
// A tile of [rows][head_dim] T is head_dim / 64 blocks of [rows][64]
// (one TMA box each, rows of 128 bytes, 128-byte swizzle), each block
// 1024-byte aligned as the swizzle and the wgmma descriptors need.
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int kConsumerWarps = 8;
constexpr int kTmaThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kSwRow = 128;  // bytes of one swizzled row: 64 of T
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int D>
struct FwdCfg {
  static constexpr int kBM = 128;                  // q rows per CTA
  static constexpr int kBN = D == 64 ? 128 : 64;   // k rows per k tile
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;     // K or V of a k tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (2 + 2 * kStages);
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

// S = Q K^T for one warpgroup: 64 x BN, both operands K-major
template <int D, int BN, typename T>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_addr,
                                         uint32_t k_addr, int q_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss<BN, T>(
        s, desc_sw128(q_addr + (kk >> 2) * q_rows * kSwRow + col, 16, 1024),
        desc_sw128(k_addr + (kk >> 2) * BN * kSwRow + col, 16, 1024), kk > 0);
  }
}

// O += P V: P from registers, V MN-major (16 k rows a step)
template <int D, int BN, typename T>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_tb<D, T>(o, pa[kk],
                   desc_sw128(v_addr + kk * 16 * kSwRow, BN * kSwRow, 1024));
}

// One tile of the online softmax in the log2 domain (m holds the running
// max of s * scale * log2(e); l this thread's share of the row sums):
// masks the tile if it is on the diagonal or ragged, turns s into p in
// place, and returns the factor for O.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float sl2, bool mask,
                                             bool causal, int S, int k0,
                                             int row0, int t) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * i + 2 * t + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        if (kpos >= S || (causal && kpos > qpos)) s[4 * i + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = ex2(m[r] - m_use);
    m[r] = m_new;
    neg_m[r] = -m_use;
  }
  // p = 2^(s * scale * log2(e) - m): one FMA and one exp2 a score
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float e0 = ex2(fmaf(s[4 * i], sl2, neg_m[0]));
    const float e1 = ex2(fmaf(s[4 * i + 1], sl2, neg_m[0]));
    const float e2 = ex2(fmaf(s[4 * i + 2], sl2, neg_m[1]));
    const float e3 = ex2(fmaf(s[4 * i + 3], sl2, neg_m[1]));
    psum[0] += e0 + e1;
    psum[1] += e2 + e3;
    s[4 * i] = e0;
    s[4 * i + 1] = e1;
    s[4 * i + 2] = e2;
    s[4 * i + 3] = e3;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
}

// p rounded to T (the TPU's p.astype(v.dtype)) as the A fragments of
// P V: k step kk is score columns 16 kk .. + 15
template <int BN, typename T>
__device__ __forceinline__ void p_to_a(const float (&s)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
    c_to_a<T>(pa[i >> 1], i & 1, s[4 * i], s[4 * i + 1], s[4 * i + 2],
           s[4 * i + 3]);
}

// The persistent forward walks its q tiles heaviest first (under causal,
// tile r of the list has the most k tiles): list index i holds q tile
// n_qt - 1 - i / (B H) of head i % (B H), and CTA c of G takes indices
// r G + c for even r and r G + G - 1 - c for odd r, a snake that deals
// the heavy tiles out evenly.
__device__ __forceinline__ int snake_index(int r, int c, int G) {
  return r * G + ((r & 1) ? G - 1 - c : c);
}

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads, 1)
    fwd_tma_kernel(const FlashParams p, const __grid_constant__ FwdMaps maps) {
  using C = FwdCfg<D>;
  constexpr int BM = C::kBM, BN = C::kBN, NS = C::kStages, CB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* ring = smem + C::kQBytes;  // stage i: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + NS;

  const int bhs = p.B * p.H;
  const int n_qt = (p.S + BM - 1) / BM;
  const int n_tiles = bhs * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      tma_prefetch(&maps.q);
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
      int it = 0;  // k tiles issued so far, over all q tiles
      for (int r = 0, n = 0;; ++r, ++n) {
        const int i = snake_index(r, blockIdx.x, gridDim.x);
        if (i >= n_tiles) break;
        const int bh = i % bhs, q0 = (n_qt - 1 - i / bhs) * BM;
        const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
        int n_kt = (p.S + BN - 1) / BN;
        if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(q_s + cb * BM * kSwRow, &maps.q, q_full, cb * 64, h, q0,
                      b);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(&empty[st], (it / NS - 1) & 1);
          uint8_t* k_s = ring + st * C::kStageBytes;
          uint8_t* v_s = k_s + C::kKVBytes;
          mbar_expect_tx(&full[st], C::kStageBytes);
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load_4d(k_s + cb * BN * kSwRow, &maps.k, &full[st], cb * 64,
                        hk, j * BN, b);
            tma_load_4d(v_s + cb * BN * kSwRow, &maps.v, &full[st], cb * 64,
                        hk, j * BN, b);
          }
        }
      }
    }
  } else {  // the consumers
    reg_alloc<kConsumerRegs>();
    // warpgroup wg owns rows 64 wg .. + 63 of each q tile; this thread
    // rows row0 and row0 + 8, columns 8 i + 2 t (+ 1) of each score tile.
    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs beside the other's wgmmas.
    // the warpgroup index, uniform for the compiler (a shuffle from lane 0)
    const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), t = lane & 3;
    const int wrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const float sl2 = p.scale * kLog2e;
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * kSwRow;
    const uint32_t ring_addr = smem_u32(ring);
    T* ob = static_cast<T*>(p.out);
    float* lse = static_cast<float*>(p.lse);
    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
    int it = 0;
    for (int r = 0, n = 0;; ++r, ++n) {
      const int i = snake_index(r, blockIdx.x, gridDim.x);
      if (i >= n_tiles) break;
      const int bh = i % bhs, q0 = (n_qt - 1 - i / bhs) * BM;
      const int b = bh / p.H, h = bh % p.H;
      int n_kt = (p.S + BN - 1) / BN;
      if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
      const int row0 = q0 + wrow, row_min = q0 + wg * 64;

      float o[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      uint32_t pa[BN / 16][4];  // P of the tile whose P V comes next

      // k tile 0: S, then its softmax
      mbar_wait(q_full, n & 1);
      mbar_wait(&full[it % NS], (it / NS) & 1);
      {
        float s[BN / 2];
        named_sync(1 + wg, 256);
        wgmma_fence();
        issue_qk<D, BN, T>(s, q_addr,
                           ring_addr + (it % NS) * C::kStageBytes, BM);
        wgmma_commit();
        named_arrive(2 - wg, 256);
        wgmma_wait<0>();
        reg_fence(s);
        if (n_kt == 1 && lane == 0) mbar_arrive(q_empty);
        softmax_tile<BN>(s, m, l, corr, sl2,
                         BN > p.S || (p.causal && BN - 1 > row_min),
                         p.causal, p.S, 0, row0, t);
        p_to_a<BN, T>(s, pa);
      }
      // k tile j: S_j = Q K_j^T runs beside O += P_{j-1} V_{j-1}, and the
      // softmax of S_j beside the rest of that product; P_j becomes A
      // fragments once that product has retired
      for (int j = 1; j < n_kt; ++j) {
        const int st = (it + j) % NS, prev = (it + j - 1) % NS, k0 = j * BN;
        const uint32_t k_addr = ring_addr + st * C::kStageBytes;
        const uint32_t v_prev =
            ring_addr + prev * C::kStageBytes + C::kKVBytes;
        mbar_wait(&full[st], ((it + j) / NS) & 1);
        float s[BN / 2];
        named_sync(1 + wg, 256);
        wgmma_fence();
        issue_qk<D, BN, T>(s, q_addr, k_addr, BM);
        wgmma_commit();
        wgmma_fence();
        issue_pv<D, BN, T>(o, pa, v_prev);
        wgmma_commit();
        named_arrive(2 - wg, 256);
        wgmma_wait<1>();
        reg_fence(s);
        if (j == n_kt - 1 && lane == 0) mbar_arrive(q_empty);
        softmax_tile<BN>(s, m, l, corr, sl2,
                         k0 + BN > p.S || (p.causal && k0 + BN - 1 > row_min),
                         p.causal, p.S, k0, row0, t);
        wgmma_wait<0>();
        reg_fence(o);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int x = 0; x < D / 8; ++x) {
          o[4 * x] *= corr[0];
          o[4 * x + 1] *= corr[0];
          o[4 * x + 2] *= corr[1];
          o[4 * x + 3] *= corr[1];
        }
        p_to_a<BN, T>(s, pa);
      }
      {
        const int last = (it + n_kt - 1) % NS;
        wgmma_fence();
        issue_pv<D, BN, T>(o, pa,
                        ring_addr + last * C::kStageBytes + C::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
        if (lane == 0) mbar_arrive(&empty[last]);
      }
      it += n_kt;

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float lr = quad_sum(l[rr]);
        const int qpos = row0 + 8 * rr;
        if (qpos >= p.S) continue;
        const float safe_l = lr == 0.f ? 1.f : lr;
        const float inv = 1.f / safe_l;
        const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
        for (int x = 0; x < D / 8; ++x)
          *reinterpret_cast<uint32_t*>(ob + row * D + 8 * x + 2 * t) =
              pack2<T>(o[4 * x + 2 * rr] * inv, o[4 * x + 2 * rr + 1] * inv);
        if (t == 0)
          lse[(long long)bh * p.S + qpos] = (m[rr] + log2f(safe_l)) * kLn2;
      }
    }
  }
}

template <int D>
struct DkvCfg {
  static constexpr int kBK = 128;                  // k rows per CTA
  static constexpr int kBQ = D == 64 ? 64 : 16;    // q rows per step
  static constexpr int kStages = 2;
  static constexpr int kKBytes = kBK * D * 2;      // K or V
  static constexpr int kQBytes = kBQ * D * 2;      // Q or dO of a step
  // lse or Delta of a step, 128-byte aligned as a TMA destination
  static constexpr int kRowBytes = (kBQ * 4 + 127) / 128 * 128;
  static constexpr int kTxBytes = 2 * kQBytes + 2 * kBQ * 4;
  static constexpr int kStageBytes =
      (2 * kQBytes + 2 * kRowBytes + 1023) / 1024 * 1024;
  static constexpr int kBarOff = 2 * kKBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (1 + 2 * kStages);
};

struct DkvMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

// acc += A . B over BQ q rows, 16 a k step, B MN-major: the high and
// then the low part of A's register fragments for each step
template <int D, int BQ, typename T>
__device__ __forceinline__ void issue_split(float (&acc)[D / 2],
                                            const uint32_t (&hi)[BQ / 16][4],
                                            const uint32_t (&lo)[BQ / 16][4],
                                            uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint64_t bd =
        desc_sw128(b_addr + kk * 16 * kSwRow, BQ * kSwRow, 1024);
    wgmma_rs_tb<D, T>(acc, hi[kk], bd);
    wgmma_rs_tb<D, T>(acc, lo[kk], bd);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads, 1)
    dkv_tma_kernel(const FlashParams p, const __grid_constant__ DkvMaps maps) {
  using C = DkvCfg<D>;
  constexpr int BK = C::kBK, BQ = C::kBQ, NS = C::kStages, CB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + C::kKBytes;
  uint8_t* ring = smem + 2 * C::kKBytes;  // stage i: Q, dO, lse, Delta
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + NS;

  const int bkv = blockIdx.x;
  const int b = bkv / p.KVH, hk = bkv % p.KVH;
  // grid.y = 0 first: the k tiles with the most q tiles under causal
  const int k0 = blockIdx.y * BK;
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int per_head = n_qt - qt0;
  const int n_steps = p.group * per_head;  // the group's q heads in turn

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      tma_prefetch(&maps.q);
      tma_prefetch(&maps.dout);
      tma_prefetch(&maps.lse);
      tma_prefetch(&maps.delta);
      mbar_expect_tx(bar_kv, 2 * C::kKBytes);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_4d(k_s + cb * BK * kSwRow, &maps.k, bar_kv, cb * 64, hk, k0,
                    b);
        tma_load_4d(v_s + cb * BK * kSwRow, &maps.v, bar_kv, cb * 64, hk, k0,
                    b);
      }
      for (int j = 0; j < n_steps; ++j) {
        const int st = j % NS;
        const int h = hk * p.group + j / per_head;
        const int q0 = (qt0 + j % per_head) * BQ;
        if (j >= NS) mbar_wait(&empty[st], (j / NS - 1) & 1);
        uint8_t* q_st = ring + st * C::kStageBytes;
        uint8_t* do_st = q_st + C::kQBytes;
        uint8_t* rows = do_st + C::kQBytes;
        mbar_expect_tx(&full[st], C::kTxBytes);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(q_st + cb * BQ * kSwRow, &maps.q, &full[st], cb * 64, h,
                      q0, b);
          tma_load_4d(do_st + cb * BQ * kSwRow, &maps.dout, &full[st],
                      cb * 64, h, q0, b);
        }
        // lse and Delta rows of [b, h, s], as one flat array: a box past
        // seq reads the next head's values, which the mask discards
        const int row = (b * p.H + h) * p.S + q0;
        tma_load_1d(rows, &maps.lse, &full[st], row);
        tma_load_1d(rows + C::kRowBytes, &maps.delta, &full[st], row);
      }
    }
  } else {  // the consumers
    reg_alloc<kConsumerRegs>();
    // warpgroup wg owns k rows kmin .. kmin + 63; this thread k rows krow
    // and krow + 8, q columns 8 i + 2 t (+ 1) of each step
    // the warpgroup index, uniform for the compiler (a shuffle from lane 0)
    const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), t = lane & 3;
    const int kmin = k0 + wg * 64;
    const int krow = kmin + (warp & 3) * 16 + (lane >> 2);
    const float sl2 = p.scale * kLog2e;
    const uint32_t k_addr = smem_u32(k_s) + wg * 64 * kSwRow;
    const uint32_t v_addr = smem_u32(v_s) + wg * 64 * kSwRow;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int j = 0; j < n_steps; ++j) {
      const int st = j % NS;
      const int q0 = (qt0 + j % per_head) * BQ;
      uint8_t* q_st = ring + st * C::kStageBytes;
      const uint32_t q_addr = smem_u32(q_st);
      const uint32_t do_addr = q_addr + C::kQBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(q_st + 2 * C::kQBytes);
      const float* dl_s = lse_s + C::kRowBytes / 4;
      mbar_wait(&full[st], (j / NS) & 1);
      // every q of this step comes before every k row of this warpgroup
      if (p.causal && q0 + BQ - 1 < kmin) {
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }

      // S^T = K Q^T and dP^T = V dO^T: 64 k rows x BQ q columns,
      // committed apart so that p is formed while dP^T still runs
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        const uint32_t a_off = (kk >> 2) * BK * kSwRow + col;
        const uint32_t b_off = (kk >> 2) * BQ * kSwRow + col;
        wgmma_ss<BQ, T>(s, desc_sw128(k_addr + a_off, 16, 1024),
                        desc_sw128(q_addr + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        const uint32_t a_off = (kk >> 2) * BK * kSwRow + col;
        const uint32_t b_off = (kk >> 2) * BQ * kSwRow + col;
        wgmma_ss<BQ, T>(dp, desc_sw128(v_addr + a_off, 16, 1024),
                        desc_sw128(do_addr + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);

      // p = exp(s * scale - lse) as one FMA and one exp2; dS = p (dP -
      // Delta) scale; both split into high and low A fragments of T
      const bool mask = q0 + BQ > p.S || (p.causal && q0 < kmin + 63);
      uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4],
          dl[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = 8 * i + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float neg_lse[2] = {-lse2.x * kLog2e, -lse2.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(s[4 * i + e], sl2, neg_lse[e & 1]));
          if (mask) {
            const int qpos = q0 + c + (e & 1), kpos = krow + 8 * (e >> 1);
            if (qpos >= p.S || (p.causal && qpos < kpos)) x = 0.f;
          }
          s[4 * i + e] = x;
        }
        const int kk = i >> 1, x = 2 * (i & 1);
        split2<T>(s[4 * i], s[4 * i + 1], ph[kk][x], pl[kk][x]);
        split2<T>(s[4 * i + 2], s[4 * i + 3], ph[kk][x + 1], pl[kk][x + 1]);
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 dl2 =
            *reinterpret_cast<const float2*>(dl_s + 8 * i + 2 * t);
        const float delta[2] = {dl2.x, dl2.y};
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = s[4 * i + e] * (dp[4 * i + e] - delta[e & 1]) * p.scale;
        const int kk = i >> 1, x = 2 * (i & 1);
        split2<T>(ds[0], ds[1], dh[kk][x], dl[kk][x]);
        split2<T>(ds[2], ds[3], dh[kk][x + 1], dl[kk][x + 1]);
      }
      wgmma_fence();
      issue_split<D, BQ, T>(dv, ph, pl, do_addr);
      issue_split<D, BQ, T>(dk, dh, dl, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    T* dkb = static_cast<T*>(p.dk);
    T* dvb = static_cast<T*>(p.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = krow + 8 * r;
      if (kpos >= p.S) continue;
      const long long row = ((long long)b * p.S + kpos) * p.KVH + hk;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dkb + row * D + 8 * i + 2 * t) =
            pack2<T>(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvb + row * D + 8 * i + 2 * t) =
            pack2<T>(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// The dQ kernel is the forward's shape with one more product: a CTA
// walks 128-row q tiles (Q and dO loaded once per tile) over the k tiles
// of its causal range, K and V streaming through the ring.  k tiles are
// 64 rows at head_dim 64 and 32 at head_dim 128, so that dQ (D / 2 fp32
// a thread), S and dP (BN / 2 each) and the dS fragments of the tile in
// flight fit the 168 registers a thread of a 384-thread CTA gets.
template <int D>
struct DqCfg {
  static constexpr int kBM = 128;                  // q rows per CTA
  static constexpr int kBN = D == 64 ? 64 : 32;    // k rows per k tile
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kBM * D * 2;      // Q or dO
  static constexpr int kKVBytes = kBN * D * 2;     // K or V of a k tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (2 + 2 * kStages);
};

struct DqMaps {
  CUtensorMap q, k, v, dout;
};

// Delta = rowsum(O dO) in fp32 for this thread's rows row0 and row0 + 8
// (the four threads of a quad read a quarter of each row, 16 bytes a
// load), and -lse log2(e) for the same rows; writes Delta for dK/dV
template <int D, typename T>
__device__ __forceinline__ void row_terms(const FlashParams& p, int b, int h,
                                          int row0, int t, float (&delta)[2],
                                          float (&nlse)[2]) {
  const T* ob = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* db = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    float d = 0.f;
    if (qpos < p.S) {
#pragma unroll
      for (int x = 0; x < D / 32; ++x) {
        const int c = t * (D / 4) + 8 * x;
        const uint4 ov =
            *reinterpret_cast<const uint4*>(ob + qpos * p.o_ss + c);
        const uint4 dv =
            *reinterpret_cast<const uint4*>(db + qpos * p.do_ss + c);
        const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
        const uint32_t* d2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = unpack2<T>(o2[e]);
          const float2 df = unpack2<T>(d2[e]);
          d += of.x * df.x + of.y * df.y;
        }
      }
    }
    d = quad_sum(d);
    delta[r] = d;
    const float lse =
        qpos < p.S ? static_cast<const float*>(p.lse)[bh * p.S + qpos] : 0.f;
    nlse[r] = -lse * kLog2e;
    if (t == 0 && qpos < p.S)
      static_cast<float*>(p.delta)[bh * p.S + qpos] = d;
  }
}

// p = exp(s scale - lse) as one FMA and one exp2, zero where the tile is
// masked (past seq, or above the diagonal under causal); in place
template <int BN>
__device__ __forceinline__ void probs_tile(float (&s)[BN / 2],
                                           const float (&nlse)[2], float sl2,
                                           bool mask, bool causal, int S,
                                           int k0, int row0, int t) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = ex2(fmaf(s[4 * i + e], sl2, nlse[e >> 1]));
      if (mask) {
        const int kpos = k0 + 8 * i + 2 * t + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        if (kpos >= S || (causal && kpos > qpos)) x = 0.f;
      }
      s[4 * i + e] = x;
    }
}

// dS = p (dP - Delta) scale in fp32, in p's registers
template <int BN>
__device__ __forceinline__ void dscore_tile(float (&s)[BN / 2],
                                            const float (&dp)[BN / 2],
                                            const float (&delta)[2],
                                            float scale) {
#pragma unroll
  for (int x = 0; x < BN / 2; ++x)
    s[x] = s[x] * (dp[x] - delta[(x >> 1) & 1]) * scale;
}

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads, 1)
    dq_tma_kernel(const FlashParams p, const __grid_constant__ DqMaps maps) {
  using C = DqCfg<D>;
  constexpr int BM = C::kBM, BN = C::kBN, NS = C::kStages, CB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + C::kQBytes;
  uint8_t* ring = smem + 2 * C::kQBytes;  // stage i: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + NS;

  const int bhs = p.B * p.H;
  const int n_qt = (p.S + BM - 1) / BM;
  const int n_tiles = bhs * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      tma_prefetch(&maps.q);
      tma_prefetch(&maps.dout);
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
      int it = 0;  // k tiles issued so far, over all q tiles
      for (int r = 0, n = 0;; ++r, ++n) {
        const int i = snake_index(r, blockIdx.x, gridDim.x);
        if (i >= n_tiles) break;
        const int bh = i % bhs, q0 = (n_qt - 1 - i / bhs) * BM;
        const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
        int n_kt = (p.S + BN - 1) / BN;
        if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(q_s + cb * BM * kSwRow, &maps.q, q_full, cb * 64, h, q0,
                      b);
          tma_load_4d(do_s + cb * BM * kSwRow, &maps.dout, q_full, cb * 64, h,
                      q0, b);
        }
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(&empty[st], (it / NS - 1) & 1);
          uint8_t* k_s = ring + st * C::kStageBytes;
          uint8_t* v_s = k_s + C::kKVBytes;
          mbar_expect_tx(&full[st], C::kStageBytes);
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load_4d(k_s + cb * BN * kSwRow, &maps.k, &full[st], cb * 64,
                        hk, j * BN, b);
            tma_load_4d(v_s + cb * BN * kSwRow, &maps.v, &full[st], cb * 64,
                        hk, j * BN, b);
          }
        }
      }
    }
  } else {  // the consumers
    reg_alloc<kConsumerRegs>();
    // warpgroup wg owns rows 64 wg .. + 63 of each q tile; this thread
    // rows row0 and row0 + 8, columns 8 i + 2 t (+ 1) of each score tile.
    // The warpgroup index comes from lane 0, uniform for the compiler;
    // the two warpgroups take turns to issue (named barriers 1 and 2).
    const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), t = lane & 3;
    const int wrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const float sl2 = p.scale * kLog2e;
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * kSwRow;
    const uint32_t do_addr = smem_u32(do_s) + wg * 64 * kSwRow;
    const uint32_t ring_addr = smem_u32(ring);
    T* dqb = static_cast<T*>(p.dq);
    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
    int it = 0;
    for (int r = 0, n = 0;; ++r, ++n) {
      const int i = snake_index(r, blockIdx.x, gridDim.x);
      if (i >= n_tiles) break;
      const int bh = i % bhs, q0 = (n_qt - 1 - i / bhs) * BM;
      const int b = bh / p.H, h = bh % p.H;
      int n_kt = (p.S + BN - 1) / BN;
      if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
      const int row0 = q0 + wrow, row_min = q0 + wg * 64;

      // Delta and lse of this thread's rows, while the copies land
      float delta[2], nlse[2];
      row_terms<D, T>(p, b, h, row0, t, delta, nlse);
      float dq[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      uint32_t da[BN / 16][4];  // dS of the tile whose dS K comes next

      // k tile 0: S and dP, then p and dS
      mbar_wait(q_full, n & 1);
      mbar_wait(&full[it % NS], (it / NS) & 1);
      {
        const uint32_t k_addr = ring_addr + (it % NS) * C::kStageBytes;
        float s[BN / 2], dp[BN / 2];
        named_sync(1 + wg, 256);
        wgmma_fence();
        issue_qk<D, BN, T>(s, q_addr, k_addr, BM);
        wgmma_commit();
        issue_qk<D, BN, T>(dp, do_addr, k_addr + C::kKVBytes, BM);
        wgmma_commit();
        named_arrive(2 - wg, 256);
        wgmma_wait<1>();
        reg_fence(s);
        probs_tile<BN>(s, nlse, sl2,
                       BN > p.S || (p.causal && BN - 1 > row_min), p.causal,
                       p.S, 0, row0, t);
        wgmma_wait<0>();
        reg_fence(dp);
        if (n_kt == 1 && lane == 0) mbar_arrive(q_empty);
        dscore_tile<BN>(s, dp, delta, p.scale);
        p_to_a<BN, T>(s, da);  // dS rounded to T, as the TPU rounds it
      }
      // k tile j: S_j and dP_j run beside dQ += dS_{j-1} K_{j-1}; p_j is
      // formed while dP_j runs and dS_j while the dQ product runs; dS_j
      // becomes A fragments once that product has retired
      for (int j = 1; j < n_kt; ++j) {
        const int st = (it + j) % NS, prev = (it + j - 1) % NS, k0 = j * BN;
        const uint32_t k_addr = ring_addr + st * C::kStageBytes;
        mbar_wait(&full[st], ((it + j) / NS) & 1);
        float s[BN / 2], dp[BN / 2];
        named_sync(1 + wg, 256);
        wgmma_fence();
        issue_qk<D, BN, T>(s, q_addr, k_addr, BM);
        wgmma_commit();
        issue_qk<D, BN, T>(dp, do_addr, k_addr + C::kKVBytes, BM);
        wgmma_commit();
        wgmma_fence();
        issue_pv<D, BN, T>(dq, da, ring_addr + prev * C::kStageBytes);
        wgmma_commit();
        named_arrive(2 - wg, 256);
        wgmma_wait<2>();
        reg_fence(s);
        probs_tile<BN>(s, nlse, sl2,
                       k0 + BN > p.S || (p.causal && k0 + BN - 1 > row_min),
                       p.causal, p.S, k0, row0, t);
        wgmma_wait<1>();
        reg_fence(dp);
        if (j == n_kt - 1 && lane == 0) mbar_arrive(q_empty);
        dscore_tile<BN>(s, dp, delta, p.scale);
        wgmma_wait<0>();
        reg_fence(dq);
        if (lane == 0) mbar_arrive(&empty[prev]);
        p_to_a<BN, T>(s, da);
      }
      {
        const int last = (it + n_kt - 1) % NS;
        wgmma_fence();
        issue_pv<D, BN, T>(dq, da, ring_addr + last * C::kStageBytes);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        if (lane == 0) mbar_arrive(&empty[last]);
      }
      it += n_kt;

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qpos = row0 + 8 * rr;
        if (qpos >= p.S) continue;
        const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
        for (int x = 0; x < D / 8; ++x)
          *reinterpret_cast<uint32_t*>(dqb + row * D + 8 * x + 2 * t) =
              pack2<T>(dq[4 * x + 2 * rr], dq[4 * x + 2 * rr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// the FMA kernels: fp32, and every dtype at head_dim 256
template <int D, int TM, typename T>
cudaError_t launch_fma(Which which, const FlashParams& p, cudaStream_t st) {
  using F = Fma<D, TM>;
  void (*kernel)(const FlashParams);
  size_t smem;
  dim3 grid((p.S + TM - 1) / TM, p.B * p.H);
  if (which == kFwd) {
    kernel = fwd_kernel<D, TM, T>;
    smem = F::kFwdSmem;
  } else if (which == kDq) {
    kernel = dq_kernel<D, TM, T>;
    smem = F::kDqSmem;
  } else {
    kernel = dkv_kernel<D, TM, T>;
    smem = F::kDkvSmem;
    grid.y = p.B * p.KVH;
  }
  // above 48 KB a launch needs the opt-in, or it is refused
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the
// library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// [b, s, heads, d] of T (bf16 or fp16) with the caller's strides (in
// elements), in boxes of [rows][64] with the 128-byte swizzle
template <typename T>
cudaError_t map_bshd(CUtensorMap* map, const void* base, const FlashParams& p,
                     int heads, long long sb, long long ss, long long sh,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)p.head_dim, (cuuint64_t)heads,
                              (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// n fp32 values as one flat array, in boxes of `len`
cudaError_t map_flat(CUtensorMap* map, const void* base, long long n,
                     int len) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // none for one dimension
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// The current device's SM count, with the kernel's shared-memory
// opt-in (Cfg::kSmem) set there: both done once per (kernel, device),
// not on every launch
template <typename Cfg, auto kKernel>
cudaError_t prepare(int* sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev].load() == 0) {
    int n = 0;
    if ((err = cudaFuncSetAttribute(
             kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             Cfg::kSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    cached[dev].store(n);
  }
  *sms = cached[dev].load();
  return cudaSuccess;
}

template <int D, typename T>
cudaError_t launch_fwd_tma(const FlashParams& p, cudaStream_t st) {
  using C = FwdCfg<D>;
  FwdMaps maps;
  cudaError_t err;
  if ((err = map_bshd<T>(&maps.q, p.q, p, p.H, p.q_sb, p.q_ss, p.q_sh,
                         C::kBM)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.k, p.k, p, p.KVH, p.k_sb, p.k_ss, p.k_sh,
                         C::kBN)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.v, p.v, p, p.KVH, p.v_sb, p.v_ss, p.v_sh,
                         C::kBN)) != cudaSuccess)
    return err;
  // persistent: one CTA per SM, or one per q tile if there are fewer
  int sms = 0;
  if ((err = prepare<C, fwd_tma_kernel<D, T>>(&sms)) != cudaSuccess)
    return err;
  const int tiles = p.B * p.H * ((p.S + C::kBM - 1) / C::kBM);
  fwd_tma_kernel<D, T>
      <<<min(sms, tiles), kTmaThreads, C::kSmem, st>>>(p, maps);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv_tma(const FlashParams& p, cudaStream_t st) {
  using C = DkvCfg<D>;
  const long long rows = (long long)p.B * p.H * p.S;
  DkvMaps maps;
  cudaError_t err;
  if ((err = map_bshd<T>(&maps.q, p.q, p, p.H, p.q_sb, p.q_ss, p.q_sh,
                         C::kBQ)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.dout, p.dout, p, p.H, p.do_sb, p.do_ss,
                         p.do_sh, C::kBQ)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.k, p.k, p, p.KVH, p.k_sb, p.k_ss, p.k_sh,
                         C::kBK)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.v, p.v, p, p.KVH, p.v_sb, p.v_ss, p.v_sh,
                         C::kBK)) != cudaSuccess ||
      (err = map_flat(&maps.lse, p.lse, rows, C::kBQ)) != cudaSuccess ||
      (err = map_flat(&maps.delta, p.delta, rows, C::kBQ)) != cudaSuccess)
    return err;
  int sms = 0;
  if ((err = prepare<C, dkv_tma_kernel<D, T>>(&sms)) != cudaSuccess)
    return err;
  const dim3 grid(p.B * p.KVH, (p.S + C::kBK - 1) / C::kBK);
  dkv_tma_kernel<D, T><<<grid, kTmaThreads, C::kSmem, st>>>(p, maps);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq_tma(const FlashParams& p, cudaStream_t st) {
  using C = DqCfg<D>;
  DqMaps maps;
  cudaError_t err;
  if ((err = map_bshd<T>(&maps.q, p.q, p, p.H, p.q_sb, p.q_ss, p.q_sh,
                         C::kBM)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.dout, p.dout, p, p.H, p.do_sb, p.do_ss,
                         p.do_sh, C::kBM)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.k, p.k, p, p.KVH, p.k_sb, p.k_ss, p.k_sh,
                         C::kBN)) != cudaSuccess ||
      (err = map_bshd<T>(&maps.v, p.v, p, p.KVH, p.v_sb, p.v_ss, p.v_sh,
                         C::kBN)) != cudaSuccess)
    return err;
  // persistent, as the forward
  int sms = 0;
  if ((err = prepare<C, dq_tma_kernel<D, T>>(&sms)) != cudaSuccess)
    return err;
  const int tiles = p.B * p.H * ((p.S + C::kBM - 1) / C::kBM);
  dq_tma_kernel<D, T>
      <<<min(sms, tiles), kTmaThreads, C::kSmem, st>>>(p, maps);
  return cudaGetLastError();
}

// bf16 and fp16 at head_dim 64 and 128: the wgmma kernels
template <int D, typename T>
cudaError_t launch_tma(Which which, const FlashParams& p, cudaStream_t st) {
  if (which == kFwd) return launch_fwd_tma<D, T>(p, st);
  if (which == kDq) return launch_dq_tma<D, T>(p, st);
  return launch_dkv_tma<D, T>(p, st);
}

// dtype: 0 fp32, 1 bf16, 2 fp16 (ops/flash_attention.py _DTYPES); the
// wrapper pads every other head_dim up to one of these
int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p->S <= 0 || p->B <= 0 || p->H <= 0) return (int)cudaSuccess;
  if (p->KVH <= 0 || p->H != p->KVH * p->group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = p->head_dim;
  switch (p->dtype) {
    case 0:
      if (d == 64) return (int)launch_fma<64, 64, float>(which, *p, st);
      if (d == 128) return (int)launch_fma<128, 64, float>(which, *p, st);
      if (d == 256) return (int)launch_fma<256, 32, float>(which, *p, st);
      break;
    case 1:
      if (d == 64) return (int)launch_tma<64, bf16>(which, *p, st);
      if (d == 128) return (int)launch_tma<128, bf16>(which, *p, st);
      if (d == 256) return (int)launch_fma<256, 32, bf16>(which, *p, st);
      break;
    case 2:
      if (d == 64) return (int)launch_tma<64, __half>(which, *p, st);
      if (d == 128) return (int)launch_tma<128, __half>(which, *p, st);
      if (d == 256) return (int)launch_fma<256, 32, __half>(which, *p, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int dlr_flash_fwd(const FlashParams* p, void* stream) {
  return dispatch(kFwd, p, stream);
}

int dlr_flash_bwd_dq(const FlashParams* p, void* stream) {
  return dispatch(kDq, p, stream);
}

int dlr_flash_bwd_dkv(const FlashParams* p, void* stream) {
  return dispatch(kDkv, p, stream);
}

const char* dlr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
