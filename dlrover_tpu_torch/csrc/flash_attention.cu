// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   forward  <- _fwd -> _fwd_kernel      (online-softmax forward)
//   dQ       <- _bwd -> _bwd_dq_kernel   (dQ; also writes the row term
//                                         Delta = rowsum(O * dO))
//   dK/dV    <- _bwd -> _bwd_dkv_kernel  (dK and dV)
// each in two versions chosen by dtype: bf16 (the training path) on the
// tensor cores with mma.sync, fp32 as FMAs on the CUDA cores.
//
// What bounds them on an H100: at GPT-2 shapes (seq 1024, head_dim 64)
// attention does ~250 FLOPs per byte it must move, near the card's
// 295 FLOP/byte balance point of bf16 tensor cores (989 TFLOP/s) and
// HBM (3.35 TB/s): a kernel that keeps the tensor cores fed is bound by
// both.  These are the simple versions: one 64-row tile per CTA, tiles
// loaded synchronously (no TMA, no double buffering), mma.sync rather
// than wgmma, so they run at a small fraction of that bound; PERF.md
// keeps the measured times beside it.  The fp32 kernels exist for exact
// checks and are bound by FMA issue (67 TFLOP/s) and shared-memory reads.
//
// Design, against the TPU kernels:
//  * The TPU walks a sequential grid and carries m/l/acc in VMEM
//    scratch across k steps.  Here one CTA owns a 64-row q tile
//    (forward, dQ) or a 64-row k tile (dK/dV) and loops over the other
//    axis itself, with the streamed tiles staged in shared memory and
//    the accumulators in registers.
//  * Causal: k tiles past the diagonal are skipped (forward, dQ) and q
//    tiles that end before the k tile are skipped (dK/dV).  The ragged
//    last tile of any seq length is masked.
//  * Rounding follows the TPU kernels: the forward rounds p to v's
//    dtype before P.V; dQ rounds dS to k's dtype before dS.K; dK/dV
//    keep p, dS, dO and q in fp32.  Masked scores are -1e30 and give
//    p = 0 exactly.
//  * GQA: q head h reads kv head h / group.  The dK/dV CTA loops the
//    group's q heads itself and writes per-kv-head sums: no atomics,
//    deterministic, and no group-sized temporary.
//  * Nothing is allocated here and nothing synchronises: each entry
//    launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kTile = 64;        // q rows and k rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kTile + 4;  // row stride of the score tiles
constexpr float kNegInf = -1e30f;

// dst[r][c] = base[(row0 + r) * row_stride + c], zero past seq
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < S ? base[(long long)row * row_stride + c] : 0.f;
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c]  (A . B^T)
template <int D>
__device__ __forceinline__ void fma_abt(const float* A, const float* Bm,
                                        float acc[4][4], int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
template <int D>
__device__ __forceinline__ void fma_pm(const float* P, const float* M,
                                       float acc[4][D / 16], int ty,
                                       int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPLd + k);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const float m0 = M[(k + 0) * LD + tx + 16 * jj];
      const float m1 = M[(k + 1) * LD + tx + 16 * jj];
      const float m2 = M[(k + 2) * LD + tx + 16 * jj];
      const float m3 = M[(k + 3) * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 4) + kTile * kPLd);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 4) + kTile * kPLd + 2 * kTile);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * kTile * (D + 4) + 2 * kTile * kPLd + 2 * kTile);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores.  Tiles are 64 x 64 with 256 threads: thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j of each score tile,
// so a row's 16 owners are one half-warp and row max/sum are shuffles.
// Shared rows are padded by 4 floats: float4 reads along head_dim are
// bank-conflict free.
//
// forward: one CTA per (b*H + h, q tile)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const FlashParams p) {
  constexpr int LD = D + 4;
  constexpr int J = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  // heaviest (most k tiles under causal) q tiles start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D>(Qs, qb, p.q_ss, q0, p.S);

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  int n_kt = (p.S + kTile - 1) / kTile;
  if (p.causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<D>(Ks, kb, p.k_ss, k0, p.S);
    load_tile<D>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[4][4] = {};
    fma_abt<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        psum += e;
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = e;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    fma_pm<D>(Ps, Vs, acc, ty, tx);
  }

  float* ob = static_cast<float*>(p.out);
  float* lse = static_cast<float*>(p.lse);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      ob[row * D + tx + 16 * jj] = acc[i][jj] / safe_l;
    if (tx == 0) lse[(long long)bh * p.S + qpos] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b*H + h, q tile); writes Delta for the dK/dV kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const FlashParams p) {
  constexpr int LD = D + 4;
  constexpr int J = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  float* lse_s = dSs + kTile * kPLd;
  float* dl_s = lse_s + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* obase = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dob =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  load_tile<D>(Qs, qb, p.q_ss, q0, p.S);
  load_tile<D>(dOs, dob, p.do_ss, q0, p.S);
  load_tile<D>(Ks, obase, p.o_ss, q0, p.S);  // O, for Delta only
  __syncthreads();

  // Delta = rowsum(O * dO) in fp32; 4 lanes per row
  {
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

  float dq[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dq[i][jj] = 0.f;

  int n_kt = (p.S + kTile - 1) / kTile;
  if (p.causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(Ks, kb, p.k_ss, k0, p.S);
    load_tile<D>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    fma_abt<D>(Qs, Ks, s, ty, tx);
    fma_abt<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok =
            qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
        const float pr = ok ? expf(s[i][j] * p.scale - lse_r) : 0.f;
        const float ds = pr * (dp[i][j] - dl_r) * p.scale;
        dSs[r * kPLd + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    fma_pm<D>(dSs, Ks, dq, ty, tx);
  }

  float* dqb = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      dqb[row * D + tx + 16 * jj] = dq[i][jj];
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (b*KVH + kv head, k tile), looping the group's q
// heads and the q tiles at or past the diagonal
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const FlashParams p) {
  constexpr int LD = D + 4;
  constexpr int J = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kPLd;
  float* lse_s = dSs + kTile * kPLd;
  float* dl_s = lse_s + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / p.KVH, hk = bkv % p.KVH;
  const int k0 = blockIdx.x * kTile;

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D>(Ks, kb, p.k_ss, k0, p.S);
  load_tile<D>(Vs, vb, p.v_ss, k0, p.S);

  // rows of dk/dv are k rows ty + 16 i, columns tx + 16 jj
  float dk[4][J], dv[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int n_qt = (p.S + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;
  const float* lse_g = static_cast<const float*>(p.lse);
  const float* dl_g = static_cast<const float*>(p.delta);

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long bh = (long long)b * p.H + h;
    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dob =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<D>(Qs, qb, p.q_ss, q0, p.S);
      load_tile<D>(dOs, dob, p.do_ss, q0, p.S);
      if (threadIdx.x < kTile) {
        const int qpos = q0 + threadIdx.x;
        const bool ok = qpos < p.S;
        lse_s[threadIdx.x] = ok ? lse_g[bh * p.S + qpos] : 0.f;
        dl_s[threadIdx.x] = ok ? dl_g[bh * p.S + qpos] : 0.f;
      }
      __syncthreads();

      // score tile: rows are q (ty + 16 i), columns are k (tx + 16 j)
      float s[4][4] = {}, dp[4][4] = {};
      fma_abt<D>(Qs, Ks, s, ty, tx);
      fma_abt<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
        const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool ok =
              qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
          const float pr = ok ? expf(s[i][j] * p.scale - lse_r) : 0.f;
          Ps[r * kPLd + tx + 16 * j] = pr;
          dSs[r * kPLd + tx + 16 * j] = pr * (dp[i][j] - dl_r) * p.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q, all fp32
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pc[4], dsc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = Ps[r * kPLd + ty + 16 * i];
          dsc[i] = dSs[r * kPLd + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float o = dOs[r * LD + tx + 16 * jj];
          const float qv = Qs[r * LD + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][jj] = fmaf(pc[i], o, dv[i][jj]);
            dk[i][jj] = fmaf(dsc[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk);
  float* dvb = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.S) continue;
    const long long row = ((long long)b * p.S + kpos) * p.KVH + hk;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      dkb[row * D + tx + 16 * jj] = dk[i][jj];
      dvb[row * D + tx + 16 * jj] = dv[i][jj];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 accumulate.
//
// Four warps per CTA, each owning 16 rows of the 64-row tile.  Tiles
// stay bf16 in shared memory (rows padded by 16 bytes: the fragment
// loads below are bank-conflict free); an operand that the product
// needs transposed is read with ldmatrix.trans.  The rounding points
// are the TPU kernels': S and dP take bf16 inputs exactly; p (forward)
// and dS (dQ) are rounded to bf16 where the TPU rounds them; dK/dV
// keep p and dS in fp32 by splitting each into a bf16 high part and a
// bf16 remainder, two products instead of one.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;

template <int D>
constexpr size_t mma_smem(int tiles, int rows) {
  return sizeof(bf16) * tiles * kTile * (D + 8) + sizeof(float) * rows;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as bf16 pairs: hi = rn(x), lo = rn(x - hi); hi + lo keeps 16
// significant bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// [64][D] bf16 tile into shared memory, 16 bytes a copy, zero past seq
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base,
                                               long long row_stride,
                                               int row0, int S) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      v = *reinterpret_cast<const uint4*>(base + (long long)row * row_stride +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// A fragment: rows row0..+15, columns col0..+15 of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int row0,
                                       int col0, int g, int t) {
  const bf16* p = s + (row0 + g) * LD + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (k = k0..+15, n = n0..+7) of a tile stored as B^T, [n][k]
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int n0, int k0, int g,
                                       int t) {
  const bf16* p = s + (n0 + g) * LD + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragments of two n tiles (n0 and n0 + 8; k = k0..+15) of a tile
// stored as B, [k][n]: b[0], b[1] for n0 and b[2], b[3] for n0 + 8
template <int LD>
__device__ __forceinline__ void frag_b_trans(uint32_t b[4], const bf16* s,
                                             int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(s + row * LD + col));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// the C fragments of n tiles 2j and 2j + 1 (cols 2t, 2t + 1 of rows g
// and g + 8) are the A fragment of k step j
__device__ __forceinline__ void c_to_a(uint32_t a[4], int hi, float c0,
                                       float c1, float c2, float c3) {
  a[2 * hi] = pack_bf16(c0, c1);
  a[2 * hi + 1] = pack_bf16(c2, c3);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    fwd_mma_kernel(const FlashParams p) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's rows
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_bf16<D>(Qs, qb, p.q_ss, q0, p.S);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  int n_kt = (p.S + kTile - 1) / kTile;
  if (p.causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<D>(Ks, kb, p.k_ss, k0, p.S);
    load_tile_bf16<D>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      frag_a<LD>(a, Qs, r0, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        frag_b<LD>(b0, b1, Ks, nt * 8, kk, g, t);
        mma_bf16(s[nt], a, b0, b1);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r0 + g + (e >> 1) * 8;
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * p.scale;
        if (kpos >= p.S || (p.causal && kpos > qpos)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new[i]);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float e0 = expf(s[nt][0] - m_new[0]);
      const float e1 = expf(s[nt][1] - m_new[0]);
      const float e2 = expf(s[nt][2] - m_new[1]);
      const float e3 = expf(s[nt][3] - m_new[1]);
      psum[0] += e0 + e1;
      psum[1] += e2 + e3;
      c_to_a(pa[nt >> 1], nt & 1, e0, e1, e2, e3);  // p rounded to bf16
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * corr[i] + quad_sum(psum[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];
        frag_b_trans<LD>(bv, Vs, j * 16, dn * 8, lane);
        mma_bf16(o[dn], pa[j], bv[0], bv[1]);
        mma_bf16(o[dn + 1], pa[j], bv[2], bv[3]);
      }
  }

  bf16* ob = static_cast<bf16*>(p.out);
  float* lse = static_cast<float*>(p.lse);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + g + 8 * i;
    if (qpos >= p.S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(ob + row * D + dn * 8 + 2 * t) =
          pack_bf16(o[dn][2 * i] / safe_l, o[dn][2 * i + 1] / safe_l);
    if (t == 0) lse[(long long)bh * p.S + qpos] = m[i] + logf(safe_l);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const FlashParams p) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + kTile * LD);
  float* dl_s = lse_s + kTile;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bf16* obase = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  load_tile_bf16<D>(Qs, qb, p.q_ss, q0, p.S);
  load_tile_bf16<D>(dOs, dob, p.do_ss, q0, p.S);
  load_tile_bf16<D>(Ks, obase, p.o_ss, q0, p.S);  // O, for Delta only
  __syncthreads();

  // Delta = rowsum(O * dO) in fp32; two threads per row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float d = 0.f;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      d += __bfloat162float(Ks[r * LD + c]) * __bfloat162float(dOs[r * LD + c]);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      const int qpos = q0 + r;
      const bool ok = qpos < p.S;
      dl_s[r] = d;
      lse_s[r] =
          ok ? static_cast<const float*>(p.lse)[(long long)bh * p.S + qpos]
             : 0.f;
      if (ok) static_cast<float*>(p.delta)[(long long)bh * p.S + qpos] = d;
    }
  }

  float dq[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  int n_kt = (p.S + kTile - 1) / kTile;
  if (p.causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<D>(Ks, kb, p.k_ss, k0, p.S);
    load_tile_bf16<D>(Vs, vb, p.v_ss, k0, p.S);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], ad[4];
      frag_a<LD>(a, Qs, r0, kk, g, t);
      frag_a<LD>(ad, dOs, r0, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        frag_b<LD>(b0, b1, Ks, nt * 8, kk, g, t);
        mma_bf16(s[nt], a, b0, b1);
        frag_b<LD>(b0, b1, Vs, nt * 8, kk, g, t);
        mma_bf16(dp[nt], ad, b0, b1);
      }
    }
    const float lse_r[2] = {lse_s[r0 + g], lse_s[r0 + g + 8]};
    const float dl_r[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};
    uint32_t da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qpos = q0 + r0 + g + 8 * i;
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok =
            qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
        const float pr = ok ? expf(s[nt][e] * p.scale - lse_r[i]) : 0.f;
        ds[e] = pr * (dp[nt][e] - dl_r[i]) * p.scale;
      }
      c_to_a(da[nt >> 1], nt & 1, ds[0], ds[1], ds[2], ds[3]);  // dS to bf16
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bk[4];
        frag_b_trans<LD>(bk, Ks, j * 16, dn * 8, lane);
        mma_bf16(dq[dn], da[j], bk[0], bk[1]);
        mma_bf16(dq[dn + 1], da[j], bk[2], bk[3]);
      }
  }

  bf16* dqb = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + g + 8 * i;
    if (qpos >= p.S) continue;
    const long long row = ((long long)b * p.S + qpos) * p.H + h;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(dqb + row * D + dn * 8 + 2 * t) =
          pack_bf16(dq[dn][2 * i], dq[dn][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    dkv_mma_kernel(const FlashParams p) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * LD);
  float* dl_s = lse_s + kTile;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's k rows
  const int bkv = blockIdx.y;
  const int b = bkv / p.KVH, hk = bkv % p.KVH;
  const int k0 = blockIdx.x * kTile;

  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_bf16<D>(Ks, kb, p.k_ss, k0, p.S);
  load_tile_bf16<D>(Vs, vb, p.v_ss, k0, p.S);

  // rows of dk/dv are k rows r0 + g (+ 8), columns dn * 8 + 2t (+ 1)
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  const int n_qt = (p.S + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;
  const float* lse_g = static_cast<const float*>(p.lse);
  const float* dl_g = static_cast<const float*>(p.delta);

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long bh = (long long)b * p.H + h;
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dob =
        static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile_bf16<D>(Qs, qb, p.q_ss, q0, p.S);
      load_tile_bf16<D>(dOs, dob, p.do_ss, q0, p.S);
      if (threadIdx.x < kTile) {
        const int qpos = q0 + threadIdx.x;
        const bool ok = qpos < p.S;
        lse_s[threadIdx.x] = ok ? lse_g[bh * p.S + qpos] : 0.f;
        dl_s[threadIdx.x] = ok ? dl_g[bh * p.S + qpos] : 0.f;
      }
      __syncthreads();

      // transposed scores: rows are k (r0 + g), columns are q
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], av[4];
        frag_a<LD>(a, Ks, r0, kk, g, t);
        frag_a<LD>(av, Vs, r0, kk, g, t);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t b0, b1;
          frag_b<LD>(b0, b1, Qs, nt * 8, kk, g, t);
          mma_bf16(st[nt], a, b0, b1);
          frag_b<LD>(b0, b1, dOs, nt * 8, kk, g, t);
          mma_bf16(dpt[nt], av, b0, b1);
        }
      }
      // one k step (16 q) at a time: p and dS split into bf16 pairs,
      // then dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int nt = 2 * j + hi;
          float pr[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + r0 + g + (e >> 1) * 8;
            const int ql = nt * 8 + 2 * t + (e & 1);
            const int qpos = q0 + ql;
            const bool ok =
                qpos < p.S && kpos < p.S && !(p.causal && kpos > qpos);
            pr[e] = ok ? expf(st[nt][e] * p.scale - lse_s[ql]) : 0.f;
            ds[e] = pr[e] * (dpt[nt][e] - dl_s[ql]) * p.scale;
          }
          split_bf16(pr[0], pr[1], ph[2 * hi], pl[2 * hi]);
          split_bf16(pr[2], pr[3], ph[2 * hi + 1], pl[2 * hi + 1]);
          split_bf16(ds[0], ds[1], dh[2 * hi], dl[2 * hi]);
          split_bf16(ds[2], ds[3], dh[2 * hi + 1], dl[2 * hi + 1]);
        }
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t bo[4], bq[4];
          frag_b_trans<LD>(bo, dOs, j * 16, dn * 8, lane);
          mma_bf16(dv[dn], ph, bo[0], bo[1]);
          mma_bf16(dv[dn], pl, bo[0], bo[1]);
          mma_bf16(dv[dn + 1], ph, bo[2], bo[3]);
          mma_bf16(dv[dn + 1], pl, bo[2], bo[3]);
          frag_b_trans<LD>(bq, Qs, j * 16, dn * 8, lane);
          mma_bf16(dk[dn], dh, bq[0], bq[1]);
          mma_bf16(dk[dn], dl, bq[0], bq[1]);
          mma_bf16(dk[dn + 1], dh, bq[2], bq[3]);
          mma_bf16(dk[dn + 1], dl, bq[2], bq[3]);
        }
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(p.dk);
  bf16* dvb = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + r0 + g + 8 * i;
    if (kpos >= p.S) continue;
    const long long row = ((long long)b * p.S + kpos) * p.KVH + hk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      *reinterpret_cast<uint32_t*>(dkb + row * D + dn * 8 + 2 * t) =
          pack_bf16(dk[dn][2 * i], dk[dn][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + row * D + dn * 8 + 2 * t) =
          pack_bf16(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// bf16 runs on the tensor cores, fp32 on the FMA kernels
template <bool kMma, int D>
cudaError_t launch(Which which, const FlashParams& p, cudaStream_t st) {
  void (*kernel)(const FlashParams);
  size_t smem;
  dim3 grid((p.S + kTile - 1) / kTile, p.B * p.H);
  if (which == kFwd) {
    kernel = kMma ? fwd_mma_kernel<D> : fwd_kernel<D>;
    smem = kMma ? mma_smem<D>(3, 0) : fwd_smem<D>();
  } else if (which == kDq) {
    kernel = kMma ? dq_mma_kernel<D> : dq_kernel<D>;
    smem = kMma ? mma_smem<D>(4, 2 * kTile) : dq_smem<D>();
  } else {
    kernel = kMma ? dkv_mma_kernel<D> : dkv_kernel<D>;
    smem = kMma ? mma_smem<D>(4, 2 * kTile) : dkv_smem<D>();
    grid.y = p.B * p.KVH;
  }
  // above 48 KB a launch needs the opt-in, or it is refused
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMma ? kMmaThreads : kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p->S <= 0 || p->B <= 0 || p->H <= 0) return (int)cudaSuccess;
  if (p->KVH <= 0 || p->H != p->KVH * p->group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0 && p->head_dim == 64)
    return (int)launch<false, 64>(which, *p, st);
  if (p->dtype == 0 && p->head_dim == 128)
    return (int)launch<false, 128>(which, *p, st);
  if (p->dtype == 1 && p->head_dim == 64)
    return (int)launch<true, 64>(which, *p, st);
  if (p->dtype == 1 && p->head_dim == 128)
    return (int)launch<true, 128>(which, *p, st);
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
