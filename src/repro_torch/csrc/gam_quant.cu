// gam_quant: the fused one-format quantize kernel for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/gam_quant.py:96
// gam_quant_blocks, the event behind the 'tensor' and 'e4m3' recipes
// (ops.quant_err): per (bm, bk) block, block amax -> Alg. 1 scale from
// the shared group mantissa (integer bit arithmetic, E8M0 exponent
// clamped to [-126, 127]) -> clip -> saturating fp8 cast -> IEEE
// division by the scale -> bf16 stored value; then the per-block sum of
// Eq. 1 relative errors on the stored values, the nonzero count and the
// block's E8M0 exponent.
//
// Bound on an H100: bytes. Per element it reads 2 B of bf16 and writes
// 2 B of bf16 (plus 12 B per block of exponent, error sum and count);
// one fp8 cast and two divisions per element are far below the FLOP
// roof. Design: one thread block per quantization block. The block is
// read from device memory once into shared memory (32 KB for 128x128);
// the amax reduction and the element pass run from there, so device
// traffic is the one read and the one write. Reductions are warp
// shuffles plus a fixed 8-warp combine (common.cuh: block_reduce), so
// a run repeats bit for bit.
//
// Numerics follow the plain version (kernels/ref.py: gam_quant_ref), not
// the Pallas kernel, where the two differ: an all-zero or nonfinite
// block scales by the guarded group amax (the reference's XLA path;
// the Pallas kernel used 1.0), which changes only that block's reported
// exponent. xq and block_exp match the plain version bit for bit. The
// error sum accumulates in f64 in a fixed order and is rounded once to
// f32, so it is the nearest f32 to the exact sum of the f32 terms; the
// plain version sums in f32 in PyTorch's order, so the two agree to
// within its rounding (1e-6 relative). Build without fast-math and with
// -fmad=false: the divisions must be IEEE and x * scale must round once.
#include "common.cuh"

#define NTHREADS REDUCE_THREADS

__global__ void __launch_bounds__(NTHREADS)
gam_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mg,
                 __nv_bfloat16* __restrict__ xq, int32_t* __restrict__ exp_out,
                 float* __restrict__ err_out, float* __restrict__ cnt_out, int Kp, int bm,
                 int bk, int algo, float q_amax, int e5m2) {
  extern __shared__ unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float fscratch[32];
  __shared__ int iscratch[32];
  __shared__ double dscratch[32];
  __shared__ float bcast;

  const int n = bm * bk;
  const int i = blockIdx.y, j = blockIdx.x, nk = gridDim.x;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)i * bm, col0 = (size_t)j * bk;
  const __nv_fp8_interpretation_t fmt = e5m2 ? __NV_E5M2 : __NV_E4M3;

  // Pass 1: load the block once; amax (NaN propagates) and nonzeros.
  float amax = 0.0f;
  int cnt = 0;
  for (int idx = tid; idx < n; idx += NTHREADS) {
    const int r = idx / bk, c = idx - r * bk;
    const __nv_bfloat16 v = x[(row0 + r) * Kp + col0 + c];
    xs[idx] = v;
    const float f = bf2f(v);
    amax = nan_max(amax, fabsf(f));
    cnt += f != 0.0f;  // NaN counts as nonzero, as in the reference
  }
  amax = block_reduce(amax, MaxOp(), fscratch);
  cnt = block_reduce(cnt, ISumOp(), iscratch);

  // The block scale: a zero or nonfinite block takes the guarded group
  // amax mg[1] (mg[0] is the group mantissa m_g).
  const int cell = i * nk + j;
  if (tid == 0) {
    const float safe_b = (amax > 0.0f && isfinite(amax)) ? amax : mg[1];
    int e_b;
    bcast = gam_scale(q_amax, mg[0], safe_b, algo, &e_b);
    exp_out[cell] = e_b;
    cnt_out[cell] = (float)cnt;
  }
  __syncthreads();
  const float scale = bcast;

  // Pass 2: stored values and the Eq. 1 error sum over nonzeros.
  double err = 0.0;
  for (int idx = tid; idx < n; idx += NTHREADS) {
    const int r = idx / bk, c = idx - r * bk;
    const float f = bf2f(xs[idx]);
    const float stored = fp8_candidate(f, scale, q_amax, fmt);
    xq[(row0 + r) * Kp + col0 + c] = f2bf(stored);
    if (f != 0.0f) err += (double)rel_err(f, stored);
  }
  err = block_reduce(err, DSumOp(), dscratch);
  if (tid == 0) err_out[cell] = (float)err;
}

extern "C" int gam_quant_launch(const void* x, const void* mg, void* xq, void* block_exp,
                                void* err_sums, void* counts, int Mp, int Kp, int bm, int bk,
                                int algo, float q_amax, int e5m2, void* stream) {
  const size_t smem = (size_t)bm * bk * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gam_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Kp / bk, Mp / bm);
  gam_quant_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)mg, (__nv_bfloat16*)xq, (int32_t*)block_exp,
      (float*)err_sums, (float*)counts, Kp, bm, bk, algo, q_amax, e5m2);
  return (int)cudaGetLastError();
}
