// Blockwise int8 quantization of optimizer state for Hopper (sm_90a):
// quantize, dequantize and the fused quantized-AdamW step.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/quantization.py:
//   quantize   <- _quantize_tiles -> _quant_kernel    (codes + row scales)
//   dequantize <- _dequantize_tiles -> _dequant_kernel (codes x scale)
//   qadam      <- fused_qadam_step -> _qadam_kernel    (dequantize both
//                 moments, AdamW, requantize, update the parameter)
//
// What bounds them on an H100: bytes.  Each does a few dozen flops per
// element it moves (qadam: ~30 per 10 bytes at bf16), far under the
// card's ~20 flop/byte fp32 balance point, so the least time is the
// bytes over 3.35 TB/s.  Nothing is reread: a row is read once into
// registers, reduced, and written once.
//
// Design, against the TPU kernels:
//  * The TPU kernels walk a sequential grid of 128-row tiles in VMEM.
//    Here one CTA of 256 threads owns one row of `block` elements
//    (the unit that shares a scale); thread t holds elements t, t+256,
//    ... in registers (8 of them at the default block of 2048, up to 32),
//    so a row is read once, reduced in registers, and written once.
//    The row absmax is a warp-shuffle max, then one pass over the eight
//    warps' maxima in shared memory; qadam reduces |mu| and sqrt(nu)
//    in the same pass.
//  * Tensors are read in place from their flat storage: element i of
//    row r is flat[r * block + i], and positions at or past numel read
//    as zero, which is what the reference's zero padding holds.  g and
//    p are read in their own dtype (bf16 or fp32) and upcast in
//    registers, so no padded fp32 copy of them is made.
//  * qadam writes the new parameter in place instead of an update
//    tensor: p_new = round_p(p + round_p(upd)), the value the
//    reference's update gives after optax.apply_updates, without the
//    update buffer.  Codes and scales are rewritten in place too: every
//    thread has read its codes and the row's scales before the
//    reduction's barrier, and they are written only after it.
//  * Rounding is the reference's, one rounding per operation: products
//    and sums are __fmul_rn / __fadd_rn, so nvcc cannot contract them
//    into FMAs; x / scale is an IEEE division (__fdiv_rn) and sqrt an
//    IEEE square root (__fsqrt_rn); rounding to an integer is rintf,
//    half to even as jnp.round.  The division of a row's absmax by the
//    constant qmax is a product with fp32(1 / qmax), as the reference's
//    XLA rewrites it.  The fp32 constants (b1, 1 - b1, ...) come from
//    the host, each a double rounded once.
//  * Nothing is allocated here and nothing synchronises: each entry
//    launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by ctypes in ops/quantization.py.
struct QAdamParams {
  void* p;
  const void* g;
  void* q_mu;
  void* mu_scales;
  void* q_nu;
  void* nu_scales;
  long long numel;
  long long rows;
  int block;
  int dtype;  // 0 float32, 1 bfloat16
  float b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, neg_lr, eps, wd;
};

namespace {

constexpr int kThreads = 256;
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

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads) qadam_kernel(QAdamParams prm) {
  T* __restrict__ p = static_cast<T*>(prm.p);
  const T* __restrict__ g = static_cast<const T*>(prm.g);
  int8_t* __restrict__ q_mu = static_cast<int8_t*>(prm.q_mu);
  int8_t* __restrict__ q_nu = static_cast<int8_t*>(prm.q_nu);
  float* __restrict__ mu_scales = static_cast<float*>(prm.mu_scales);
  float* __restrict__ nu_scales = static_cast<float*>(prm.nu_scales);
  const int block = prm.block;
  const long long row0 = static_cast<long long>(blockIdx.x) * block;
  const float mu_s = mu_scales[blockIdx.x];
  const float nu_s = nu_scales[blockIdx.x];

  float mu[VPT];
  float nu_sqrt[VPT];
  float mu_absmax = 0.0f;
  float nu_max = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = j * kThreads + threadIdx.x;
    mu[j] = 0.0f;
    nu_sqrt[j] = 0.0f;
    if (i >= block) continue;
    const long long e = row0 + i;
    const bool inside = e < prm.numel;
    const float gv = inside ? to_float(g[e]) : 0.0f;
    const float pv = inside ? to_float(p[e]) : 0.0f;
    const float m0 = __fmul_rn(static_cast<float>(q_mu[e]), mu_s);
    const float s0 = __fmul_rn(static_cast<float>(q_nu[e]), nu_s);
    // nu = b2 * s * s + (1 - b2) * g * g;  mu = b1 * m + (1 - b1) * g
    const float nu = __fadd_rn(
        __fmul_rn(__fmul_rn(prm.b2, s0), s0),
        __fmul_rn(__fmul_rn(prm.one_minus_b2, gv), gv));
    const float m = __fadd_rn(__fmul_rn(prm.b1, m0),
                              __fmul_rn(prm.one_minus_b1, gv));
    // upd = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
    const float m_hat = __fdiv_rn(m, prm.bc1);
    const float v_hat = __fdiv_rn(nu, prm.bc2);
    const float adam =
        __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), prm.eps));
    const float upd =
        __fmul_rn(prm.neg_lr, __fadd_rn(adam, __fmul_rn(prm.wd, pv)));
    if (inside) {
      const float upd_p = to_float(from_float<T>(upd));
      p[e] = from_float<T>(__fadd_rn(pv, upd_p));
    }
    mu[j] = m;
    nu_sqrt[j] = __fsqrt_rn(nu);
    mu_absmax = fmaxf(mu_absmax, fabsf(m));
    nu_max = fmaxf(nu_max, nu_sqrt[j]);
  }
  block_max2(mu_absmax, nu_max);
  const float mu_scale = fmaxf(__fmul_rn(mu_absmax, kInv127), kScaleFloor);
  const float nu_scale = fmaxf(__fmul_rn(nu_max, kInv127), kScaleFloor);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i >= block) continue;
    const long long e = row0 + i;
    q_mu[e] = encode(mu[j], mu_scale, -127.0f, 127.0f);
    q_nu[e] = encode(nu_sqrt[j], nu_scale, 0.0f, 127.0f);
  }
  if (threadIdx.x == 0) {
    mu_scales[blockIdx.x] = mu_scale;
    nu_scales[blockIdx.x] = nu_scale;
  }
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
  } else if (block <= 32 * kThreads) {
    launch_quantize<T, 32>(x, numel, rows, block, qmax, inv_qmax, q,
                           scales, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int qadam_dispatch(const QAdamParams* p, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(p->rows);
  if (p->block <= 8 * kThreads) {
    qadam_kernel<T, 8><<<grid, kThreads, 0, stream>>>(*p);
  } else if (p->block <= 32 * kThreads) {
    qadam_kernel<T, 32><<<grid, kThreads, 0, stream>>>(*p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (p->rows <= 0 || p->rows > 0x7fffffffLL || p->block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 1) return qadam_dispatch<__nv_bfloat16>(p, s);
  return qadam_dispatch<float>(p, s);
}

const char* dlr_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
