// fp8_gemm: the per-block-scaled fp8 GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fp8_gemm.py:59 fp8_gemm:
// C = sum_kb (A_q[:, kb] B_q[kb, :]) / (a_scale[i, kb] * b_scale[kb, j])
// with A_q (M, K) and B_q (K, N) fp8 payloads (E4M3 or E5M2, each
// operand its own), one f32 scale per (bm, bk) block of A and (bk, bn)
// block of B, an f32 partial per K block, f32 accumulation across K
// blocks, one cast to bf16 or f32 at the end.
//
// Bound on an H100: operations (2 M N K; the fp8 tensor-core peak is
// 1,979 TFLOP/s), bytes only for skinny M. Design (a first, simple
// version): one thread block of 256 threads per 128 x 128 output tile,
// each thread an 8 x 8 register tile. The K loop walks the scale grid's
// K blocks in 32-deep steps: each step decodes a 128 x 32 tile of A
// (stored k-major, i.e. transposed) and a 32 x 128 tile of B (row-major
// as it lies) from fp8 bytes to f32 in shared memory -- exact for both
// formats -- and runs an outer-product f32 loop on CUDA cores. After a
// K block, acc += partial / (sa * sb) per element, as the TPU kernel
// does (IEEE division, no fast-math), so any bm, bn that divide M, N
// work. The fp8 tensor cores are not used here: Hopper's fp8 MMA is
// reported to keep fewer accumulator bits than f32, which would move the
// result beyond an f32-summation-order tolerance of the reference.
//
// Needs bk % 32 == 0, N % 16 == 0, K % bk == 0 and 16-byte aligned
// operands (the wrapper checks).
#include "common.cuh"

#define G_THREADS 256
#define G_TM 128
#define G_TN 128
#define G_TK 32
#define G_LD (G_TM + 4)  // padded row of both shared tiles

__device__ __forceinline__ void decode16(const uint4 raw, __nv_fp8_interpretation_t fmt,
                                         float* out) {
  const uint8_t* by = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = fp8_to_float(by[i], fmt);
}

__global__ void __launch_bounds__(G_THREADS)
fp8_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const float* __restrict__ sa, const float* __restrict__ sb, void* __restrict__ out,
                int M, int N, int K, int bm, int bn, int bk, int a_e5m2, int b_e5m2,
                int out_f32) {
  __shared__ __align__(16) float As[G_TK][G_LD];  // A tile, k-major
  __shared__ __align__(16) float Bs[G_TK][G_LD];  // B tile, row-major
  const __nv_fp8_interpretation_t fa = a_e5m2 ? __NV_E5M2 : __NV_E4M3;
  const __nv_fp8_interpretation_t fb = b_e5m2 ? __NV_E5M2 : __NV_E4M3;
  const int m0 = blockIdx.y * G_TM, n0 = blockIdx.x * G_TN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nkb = K / bk, nbn = N / bn;

  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    cols[i] = n0 + (i >> 2) * 64 + tx * 4 + (i & 3);
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Loader roles: A row ar, k half ac; B row br, column chunk bc.
  const int ar = tid & 127, ac = (tid >> 7) * 16;
  const int br = tid >> 3, bc = (tid & 7) * 16;

  for (int kb = 0; kb < nkb; ++kb) {
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;

    for (int kc = kb * bk; kc < (kb + 1) * bk; kc += G_TK) {
      __syncthreads();  // the previous step's tiles are consumed
      float va[16], vb[16];
      if (m0 + ar < M) {
        decode16(*reinterpret_cast<const uint4*>(a + (size_t)(m0 + ar) * K + kc + ac), fa, va);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) va[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) As[ac + i][ar] = va[i];
      if (n0 + bc < N) {
        decode16(*reinterpret_cast<const uint4*>(b + (size_t)(kc + br) * N + n0 + bc), fb, vb);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) vb[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; i += 4)
        *reinterpret_cast<float4*>(&Bs[br][bc + i]) =
            make_float4(vb[i], vb[i + 1], vb[i + 2], vb[i + 3]);
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < G_TK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] += av[i] * bv[j];
      }
    }

    // The K block's partial, divided by its two block scales.
    float s_a[8], s_b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_a[i] = rows[i] < M ? sa[(size_t)(rows[i] / bm) * nkb + kb] : 1.0f;
      s_b[i] = cols[i] < N ? sb[(size_t)kb * nbn + cols[i] / bn] : 1.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j] / (s_a[i] * s_b[j]);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (rows[i] >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cols[j] >= N) continue;
      const size_t o = (size_t)rows[i] * N + cols[j];
      if (out_f32)
        reinterpret_cast<float*>(out)[o] = acc[i][j];
      else
        reinterpret_cast<__nv_bfloat16*>(out)[o] = f2bf(acc[i][j]);
    }
  }
}

extern "C" int fp8_gemm_launch(const void* a_q, const void* b_q, const void* a_scale,
                               const void* b_scale, void* out, int M, int N, int K, int bm,
                               int bn, int bk, int a_e5m2, int b_e5m2, int out_f32,
                               void* stream) {
  if (bk % G_TK || K % bk || N % 16 || M % bm || N % bn) return (int)cudaErrorInvalidValue;
  dim3 grid((N + G_TN - 1) / G_TN, (M + G_TM - 1) / G_TM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  fp8_gemm_kernel<<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a_q, (const uint8_t*)b_q, (const float*)a_scale, (const float*)b_scale,
      out, M, N, K, bm, bn, bk, a_e5m2, b_e5m2, out_f32);
  return (int)cudaGetLastError();
}
