// Shared device helpers for the MoR CUDA kernels: bf16/fp8 conversions
// with the reference's rounding (RNE, saturating fp8 after an explicit
// clip), NaN-propagating min/max (jnp.max/jnp.min semantics), the
// Alg. 1 bit arithmetic (gam_scale), the stored value of an fp8
// candidate, the E2M1 grid snap, and the fixed-order block reduction
// of the one-block-per-thread-block quantization kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TAG_E4M3 0
#define TAG_E5M2 1
#define TAG_BF16 2
#define TAG_NVFP4 3
#define NVFP4_MICRO 16

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ __nv_bfloat16 f2bf(float v) {
  return __float2bfloat16_rn(v);
}

// Stored-value rounding (Fig. 4): round to bf16 and back.
__device__ __forceinline__ float round_bf16(float v) {
  return bf2f(f2bf(v));
}

__device__ __forceinline__ float fp8_to_float(uint8_t b, __nv_fp8_interpretation_t fmt) {
  __half_raw hr = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, fmt);
  return __half2float(__half(hr));
}

// max/min that propagate NaN like jnp.max / jnp.min (fmaxf drops NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// jnp.clip(x, -q, q): NaN stays NaN.
__device__ __forceinline__ float clip_sym(float x, float q) {
  return isnan(x) ? x : fminf(fmaxf(x, -q), q);
}

// Clip, then a saturating RNE cast to fp8 (the clip makes SATFINITE a
// no-op on finite values; torch and ml_dtypes disagree on overflow).
__device__ __forceinline__ uint8_t to_fp8(float x, float q_amax, __nv_fp8_interpretation_t fmt) {
  return (uint8_t)__nv_cvt_float_to_fp8(clip_sym(x, q_amax), __NV_SATFINITE, fmt);
}

// Exact 2^e for e clamped to the full E8M0 domain [-126, 127].
__device__ __forceinline__ float exp2i(int e) {
  e = e < -126 ? -126 : (e > 127 ? 127 : e);
  return __int_as_float((e + 127) << 23);
}

enum { ALGO_GAM = 0, ALGO_E8M0 = 1, ALGO_FP32_AMAX = 2 };

// Alg. 1 per-block scale from the guarded block amax, by integer bit
// arithmetic as in the Pallas kernels (no frexp). *e_out receives the
// block's E8M0 exponent as the reference reports it: the Alg. 1 exponent
// clamped to [-126, 127] for gam / e8m0, the raw exponent of the ideal
// scale for fp32_amax.
//
// safe_b is positive, finite and at most f32max, so the ideal scale s_b
// is never subnormal: it is a normal float or, for a block whose amax is
// below q_amax / f32max (~1.3e-36 for E4M3), +Inf. The reference splits
// s_b with frexp, which gives +Inf a mantissa of +Inf and an exponent of
// -1 (frexp's 0, less one): the gam branch then keeps e_b = -1 (m_g <=
// Inf), e8m0 scales by 2^-1 and fp32_amax by Inf. Reading Inf's bits
// instead would give exponent 128 and mantissa 1.0.
__device__ __forceinline__ float gam_scale(float q_amax, float m_g, float safe_b, int algo,
                                           int* e_out = nullptr) {
  const float s_b = q_amax / safe_b;
  const int bits = __float_as_int(s_b);
  const bool inf = isinf(s_b);
  int e_b = inf ? -1 : ((bits >> 23) & 0xFF) - 127;
  const float m_b = inf ? s_b : __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  if (algo == ALGO_GAM) {
    if (!(m_g <= m_b)) e_b -= 1;  // avoid saturation when m_g > m_b
    e_b = e_b < -126 ? -126 : (e_b > 127 ? 127 : e_b);
    if (e_out) *e_out = e_b;
    return m_g * exp2i(e_b);
  }
  if (algo == ALGO_E8M0) {
    e_b = e_b < -126 ? -126 : (e_b > 127 ? 127 : e_b);
    if (e_out) *e_out = e_b;
    return exp2i(e_b);
  }
  if (e_out) *e_out = e_b;
  return s_b;
}

// Stored (bf16) value of one fp8 candidate of x under `scale`: clip,
// saturating cast, IEEE division by the scale, RNE to bf16.
__device__ __forceinline__ float fp8_candidate(float x, float scale, float q_amax,
                                               __nv_fp8_interpretation_t fmt) {
  uint8_t b = to_fp8(x * scale, q_amax, fmt);
  return round_bf16(fp8_to_float(b, fmt) / scale);
}

// Eq. 1 relative error of one nonzero element against its stored value.
__device__ __forceinline__ float rel_err(float x, float stored) {
  return fabsf((x - stored) / x);
}

// Block-wide reduction in a fixed order for REDUCE_THREADS-thread
// blocks: warp shuffles, then the eight warp results combined within
// lanes 0..7 of warp 0 (xor offsets < 8 never mix lanes of different
// groups of eight). `scratch` holds at least 8 values.
#define REDUCE_THREADS 256

// Opt a one-CTA-per-block kernel in to `dyn` bytes of dynamic shared
// memory. A CTA may use 48 KB of shared memory by default, and that limit
// counts the kernel's static __shared__ scratch as well as the dynamic
// buffer, so a dynamic buffer of 48 KB or a little less fails to launch
// (cudaErrorInvalidValue) unless the kernel is opted in. So the attribute
// is raised to every dynamic size a launch asks for, whatever its size;
// `set` (one entry per device) keeps the largest already set, so repeats
// skip the attribute call. A total beyond the card's opt-in limit still
// fails here: the Python wrappers refuse such a block by name before the
// launch.
template <typename K>
static cudaError_t opt_in_smem(K kernel, size_t dyn, int* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if ((int)dyn <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err == cudaSuccess) set[dev] = (int)dyn;
  return err;
}

// The static __shared__ bytes of a kernel, as the card reports them (-1 on
// an error).
template <typename K>
static int static_smem(K kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? (int)a.sharedSizeBytes : -1;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  static_assert(REDUCE_THREADS == 256, "the second stage combines 8 warps");
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of scratch[0] are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = scratch[lane & 7];
    for (int o = 4; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

struct MaxOp { __device__ float operator()(float a, float b) const { return nan_max(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return nan_min(a, b); } };
struct FMinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };
struct DSumOp { __device__ double operator()(double a, double b) const { return a + b; } };
struct ISumOp { __device__ int operator()(int a, int b) const { return a + b; } };

// E2M1 grid spacing at |a| in [0, 6]: 2^(floor(log2(max(a, 1))) - 1).
__device__ __forceinline__ float e2m1_ulp(float a) {
  float a1 = nan_max(a, 1.0f);
  int e = ((__float_as_int(a1) >> 23) & 0xFF) - 127;
  return __int_as_float((e - 1 + 127) << 23);
}

// RNE snap to the E2M1 grid, saturating at +-6 (rintf is half-to-even;
// roundf would round half away from zero).
__device__ __forceinline__ float round_e2m1(float x) {
  float a = nan_min(fabsf(x), 6.0f);
  float ulp = e2m1_ulp(a);
  float mag = rintf(a / ulp) * ulp;
  return x < 0.0f ? -mag : mag;
}

// E2M1 grid value -> 4-bit code (sign << 3 | magnitude code).
__device__ __forceinline__ int encode_e2m1(float v) {
  float m = fabsf(v);
  float ulp = e2m1_ulp(m);
  int e = ((__float_as_int(nan_max(m, 1.0f)) >> 23) & 0xFF) - 127;
  int hi = 4 + 2 * (e - 1) + (int)(m / ulp) - 2;
  int code = m < 2.0f ? (int)(m * 2.0f) : hi;
  return code | ((v < 0.0f ? 1 : 0) << 3);
}

__device__ __forceinline__ float decode_e2m1(int code) {
  const int m = code & 7;
  float mag = m < 4 ? 0.5f * (float)m
                    : (1.0f + 0.5f * (float)(m & 1)) * (m >= 6 ? 4.0f : 2.0f);
  return (code >> 3) ? -mag : mag;
}
