// gam_quant: the fused one-format quantize kernel for Hopper, on two routes.
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
// 2 B of bf16 (plus 12 B per block of exponent, error sum and count).
// Two routes, chosen by the block alone (kernels/gam_quant.py
// gam_quant_route):
//   * tile (gam_quant_tile_launch): the 128 x 128 block of every main
//     path, in the layout of tile.cuh. A persistent grid walks the
//     blocks over a ring of 32 KB TMA boxes; each thread holds its 4 x 16
//     elements in registers. Pass 1 reduces amax, the nonzero count and
//     the nonzero min in one all-reduce with one barrier, and every thread
//     derives the scale itself. Each warp then tabulates the 128 fp8
//     magnitudes' stored values under the block's scale, so no element
//     divides by it; pass 2 looks each code up, writes xq with 16-byte
//     stores and sums Eq. 1 (div_in_range where the block's nonzero |x|
//     lie in [2^-80, 2^80), the IEEE division otherwise), then one more
//     all-reduce in a fixed order. The clip is left to SATFINITE, which
//     maps every value beyond the format's max, Inf included, to the max
//     and keeps NaN, so the launcher takes only the format's own q_amax.
//   * generic (gam_quant_launch): any other block. One thread block per
//     quantization block reads it once into shared memory and runs both
//     passes from there; reductions are warp shuffles plus a fixed 8-warp
//     combine (common.cuh: block_reduce).
//
// Numerics follow the plain version (kernels/ref.py: gam_quant_ref), not
// the Pallas kernel, where the two differ: an all-zero or nonfinite
// block scales by the guarded group amax (the reference's XLA path;
// the Pallas kernel used 1.0), which changes only that block's reported
// exponent. xq and block_exp match the plain version bit for bit on both
// routes. The error sum accumulates each f32 term in f64 in a fixed
// order and is rounded once to f32, so repeats are bit-identical and the
// sum is within about one f32 rounding of the exact sum of the terms;
// the plain version sums in f32 in PyTorch's order, so the two agree to
// within its rounding (1e-6 relative). Build without fast-math and with
// -fmad=false: the divisions must be IEEE and x * scale must round once.
#include "tile.cuh"

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
  static int set[64] = {0};
  const cudaError_t err = opt_in_smem(gam_quant_kernel, smem, set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Kp / bk, Mp / bm);
  gam_quant_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)mg, (__nv_bfloat16*)xq, (int32_t*)block_exp,
      (float*)err_sums, (float*)counts, Kp, bm, bk, algo, q_amax, e5m2);
  return (int)cudaGetLastError();
}

// The generic kernel's static shared memory per CTA (bytes) as the card
// reports it; kernels/gam_quant.py:gam_quant_smem_bytes counts the same
// bytes on the host.
extern "C" int gam_quant_generic_static_smem() { return static_smem(gam_quant_kernel); }

// ---------------------------------------------------------------------------
// The tile route: 128 x 128 blocks (geometry, register layout and helpers
// in tile.cuh).

// Pass 2 of the tile kernel: a thread's xq rows (16-byte stores from dst,
// one block row = Kp elements apart) and its f64 sum of Eq. 1 errors on
// the stored values. One row run per iteration of a loop the compiler
// keeps rolled, its run rotated to the front of xr, so it cannot hoist
// every run's reciprocals at once; xr ends in its original order.
template <__nv_fp8_interpretation_t F, bool kInRange>
__device__ __forceinline__ double quant_rows(uint32_t* xr, float s, const uint16_t* tab,
                                             __nv_bfloat16* dst, int Kp) {
  double err = 0.0;
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
    uint32_t o[8];
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const float f0 = lo_f(xr[h]), f1 = hi_f(xr[h]);
      const uint32_t c = fp8x2<F>(f0 * s, f1 * s);
      const uint32_t v0 = stored_bits(tab, c & 0xFFu), v1 = stored_bits(tab, c >> 8);
      o[h] = (v0 >> 16) | (v1 & 0xFFFF0000u);
      // NaN counts as nonzero, as in the reference.
      err += f0 != 0.0f ? (double)eq1_err<kInRange>(f0, __uint_as_float(v0)) : 0.0;
      err += f1 != 0.0f ? (double)eq1_err<kInRange>(f1, __uint_as_float(v1)) : 0.0;
    }
    __nv_bfloat16* d = dst + (size_t)(32 * p) * Kp;
    st16(d, make_uint4(o[0], o[1], o[2], o[3]));
    st16(d + 8, make_uint4(o[4], o[5], o[6], o[7]));
    rotate<32, 8>(xr);
  }
  return err;
}

// One persistent CTA of the tile route. xmap describes x (Mp x Kp bf16)
// in 128 x 128 boxes.
template <__nv_fp8_interpretation_t F>
__global__ void __launch_bounds__(T_THREADS, T_CTAS)
gam_quant_tile_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ mg,
                      __nv_bfloat16* __restrict__ xq, int32_t* __restrict__ exp_out,
                      float* __restrict__ err_out, float* __restrict__ cnt_out, int Kp, int nk,
                      int nblocks, int algo, float q_amax) {
  extern __shared__ unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[T_STAGES];
  __shared__ uint16_t tabs[T_WARPS][128];  // per warp: the fp8 magnitudes' stored values
  __shared__ float4 red1[T_WARPS];
  __shared__ double red2[T_WARPS];
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(((uintptr_t)dsmem + 127) & ~(uintptr_t)127);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rq = tid >> 3, cq = tid & 7;
  const float mg0 = mg[0], mg1 = mg[1];
  uint16_t* tab = tabs[warp];
  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < T_STAGES; ++s) {
      const int b = blockIdx.x + s * gridDim.x;
      if (b < nblocks) issue_block(&xmap, ring, full, b, s, nk);
    }

  int k = 0;
  for (int b = blockIdx.x; b < nblocks; b += gridDim.x, ++k) {
    const int i = b / nk, j = b - i * nk;
    uint32_t xr[32];
    const int s = k % T_STAGES;
    mbar_wait(&full[s], (uint32_t)(k / T_STAGES) & 1u);
    {
      // Quarter warps read 128 contiguous bytes: threads 4-7 of each
      // eight take their row's second 16 B first (no bank conflict).
      const int sw = (tid >> 2) & 1;
      const unsigned char* st = ring + s * T_BOX + rq * (TILE * 2) + cq * 32;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint4 a = *reinterpret_cast<const uint4*>(st + p * 32 * (TILE * 2) + 16 * sw);
        const uint4 c = *reinterpret_cast<const uint4*>(st + p * 32 * (TILE * 2) + 16 * (sw ^ 1));
        const uint4 lo = sw ? c : a, hi = sw ? a : c;
        xr[p * 8 + 0] = lo.x; xr[p * 8 + 1] = lo.y; xr[p * 8 + 2] = lo.z; xr[p * 8 + 3] = lo.w;
        xr[p * 8 + 4] = hi.x; xr[p * 8 + 5] = hi.y; xr[p * 8 + 6] = hi.z; xr[p * 8 + 7] = hi.w;
      }
    }

    // Pass 1: amax (NaN propagates), nonzero count and nonzero min (the
    // min only decides div_in_range's domain); a chain per row run.
    float amax = 0.0f, bmin = F32_BIG;
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float m = 0.0f, n = F32_BIG;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const float f0 = lo_f(xr[p * 8 + h]), f1 = hi_f(xr[p * 8 + h]);
        const float a0 = fabsf(f0), a1 = fabsf(f1);
        m = max_nan(max_nan(m, a0), a1);
        cnt += (f0 != 0.0f) + (f1 != 0.0f);  // NaN counts as nonzero
        n = min_nan(n, f0 != 0.0f ? a0 : F32_BIG);
        n = min_nan(n, f1 != 0.0f ? a1 : F32_BIG);
      }
      amax = max_nan(amax, m);
      bmin = min_nan(bmin, n);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      bmin = min_nan(bmin, __shfl_xor_sync(0xffffffffu, bmin, o));
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) red1[warp] = make_float4(amax, bmin, __int_as_float(cnt), 0.0f);
    __syncthreads();  // every thread has read its block out of the ring slot
    if (tid == 0 && b + T_STAGES * (int)gridDim.x < nblocks) {
      // The slot's generic reads before the TMA's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_block(&xmap, ring, full, b + T_STAGES * gridDim.x, s, nk);
    }
    {
      const float4 r = red1[0];
      amax = r.x, bmin = r.y, cnt = __float_as_int(r.z);
    }
#pragma unroll
    for (int w = 1; w < T_WARPS; ++w) {
      const float4 r = red1[w];
      amax = max_nan(amax, r.x);
      bmin = min_nan(bmin, r.y);
      cnt += __float_as_int(r.z);
    }

    // The scale (every thread): a zero or nonfinite block scales by the
    // guarded group amax mg[1] (mg[0] is the group mantissa m_g).
    const float safe_b = (amax > 0.0f && isfinite(amax)) ? amax : mg1;
    int e_b;
    const float scale = gam_scale(q_amax, mg0, safe_b, algo, &e_b);

    // The warp's stored-value table: magnitude codes 0..127 through
    // fp8_candidate's IEEE division by the scale and RNE to bf16. The
    // last block's readers passed the barrier above.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      tab[c] = __bfloat16_as_ushort(f2bf(fp8_to_float((uint8_t)c, F) / scale));
    }
    __syncwarp();

    // Pass 2: xq and the Eq. 1 error sum on the stored values.
    __nv_bfloat16* dst = xq + ((size_t)i * TILE + rq) * Kp + (size_t)j * TILE + cq * 16;
    double err;
    if (bmin >= 0x1p-80f && amax < 0x1p80f)  // NaN fails both
      err = quant_rows<F, true>(xr, scale, tab, dst, Kp);
    else
      err = quant_rows<F, false>(xr, scale, tab, dst, Kp);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) err += __shfl_xor_sync(0xffffffffu, err, o);
    if (lane == 0) red2[warp] = err;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < T_WARPS; ++w) err += red2[w];  // a fixed order: repeats are bit-identical
      err_out[b] = (float)err;
      exp_out[b] = e_b;
      cnt_out[b] = (float)cnt;
    }
  }
}

template <__nv_fp8_interpretation_t F>
static int tile_launch(const void* x, const void* mg, void* xq, void* block_exp, void* err_sums,
                       void* counts, int Mp, int Kp, int algo, float q_amax, void* stream) {
  static int sms[64] = {0};
  CUtensorMap map;
  int nk, nblocks, grid;
  const cudaError_t err =
      tile_setup(gam_quant_tile_kernel<F>, sms, x, Mp, Kp, &map, &nk, &nblocks, &grid);
  if (err != cudaSuccess) return (int)err;
  gam_quant_tile_kernel<F><<<grid, T_THREADS, T_SMEM, (cudaStream_t)stream>>>(
      map, (const float*)mg, (__nv_bfloat16*)xq, (int32_t*)block_exp, (float*)err_sums,
      (float*)counts, Kp, nk, nblocks, algo, q_amax);
  return (int)cudaGetLastError();
}

// The tile route: 128 x 128 blocks only (the arguments of the generic
// route without bm and bk). q_amax must be the format's max (448 or
// 57344): SATFINITE stands in for the clip.
extern "C" int gam_quant_tile_launch(const void* x, const void* mg, void* xq, void* block_exp,
                                     void* err_sums, void* counts, int Mp, int Kp, int algo,
                                     float q_amax, int e5m2, void* stream) {
  if (q_amax != (e5m2 ? 57344.0f : 448.0f)) return (int)cudaErrorInvalidValue;
  if (e5m2)
    return tile_launch<__NV_E5M2>(x, mg, xq, block_exp, err_sums, counts, Mp, Kp, algo, q_amax,
                                  stream);
  return tile_launch<__NV_E4M3>(x, mg, xq, block_exp, err_sums, counts, Mp, Kp, algo, q_amax,
                                stream);
}

// The tile launcher's dynamic shared memory per CTA (bytes).
extern "C" int gam_quant_tile_smem() { return T_SMEM; }
