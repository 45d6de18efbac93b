// mixed_gemm: the mixed-representation block GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mixed_gemm.py:214
// mixed_gemm_blocks: C = A @ B^T over two MixedOperands, every (br, bk)
// block decoded per its tag (E4M3 / E5M2 / BF16 / NVFP4) to its stored
// bf16 value -- bf16(fp8 / scale), the BF16 passthrough, or
// bf16(f32(e2m1 * micro) / scale) -- and accumulated in f32, cast once
// to the output dtype.
//
// Bound on an H100: bytes. Serving GEMMs have a handful of activation
// rows (decode: M = slots; prefill: one chunk), so the weight's payload
// (~1 B/element for fp8 blocks) dominates the traffic and the FLOPs are
// far below the roof. Design: one output tile (16/32/64 rows x 64
// columns) per 256-thread block, a loop over K in pack-block steps
// (chunks of 32 inside each pack block, so one tag and scale hold per
// tile row), per-row tag/scale/nibble metadata in shared memory, an fp8
// decode table in shared memory, decoded values staged in shared memory
// as f32, and f32 FMAs on CUDA cores (a bf16 x bf16 product is exact in
// f32, so only the order of the sum differs from the plain version).
// A lane is read only where a tag names it, so compact lanes are never
// touched. When the output tiles alone cannot fill the card (decode
// against a 4096-wide weight) K is split across blocks into an f32
// workspace that a second kernel sums in a fixed order. No wgmma, TMA
// or pipelining yet.
#include "common.cuh"

#define BN 64
#define KC 32
#define NTHREADS 256

struct Operand {
  const uint8_t* q;
  const __nv_bfloat16* bf;
  const uint8_t* nib;
  const uint8_t* ms;
  const int32_t* tags;
  const float* scales;
  int br;     // row block of the pack
  int rows;   // logical rows (M for A, N for B)
  int q_dense, bf_dense, nv;  // lanes that may be read
};

struct RowMeta {
  int tag;     // -1: row outside the operand (decodes to 0)
  float scale;
  int nib_row; // NVFP4: byte row of the row-halves packed nibble lane
  int nib_shift;
};

__device__ __forceinline__ RowMeta row_meta(const Operand& P, int row, int kb, int nk) {
  RowMeta m;
  if (row >= P.rows) {
    m.tag = -1; m.scale = 1.0f; m.nib_row = 0; m.nib_shift = 0;
    return m;
  }
  const int rb = row / P.br, r_in = row - rb * P.br, half = P.br >> 1;
  m.tag = P.tags[rb * nk + kb];
  m.scale = P.scales[rb * nk + kb];
  m.nib_row = rb * half + (r_in < half ? r_in : r_in - half);
  m.nib_shift = r_in < half ? 0 : 4;
  return m;
}

// Stored value of element (row, k) of a block with metadata m.
__device__ __forceinline__ float decode(const Operand& P, const RowMeta& m, int row, int k,
                                        int Kp, const float* lut) {
  if (m.tag < 0) return 0.0f;
  if (m.tag == TAG_BF16) return P.bf_dense ? bf2f(P.bf[(size_t)row * Kp + k]) : 0.0f;
  if (m.tag == TAG_NVFP4 && P.nv) {
    const int code = (P.nib[(size_t)m.nib_row * Kp + k] >> m.nib_shift) & 15;
    const float d = lut[P.ms[(size_t)row * (Kp / NVFP4_MICRO) + k / NVFP4_MICRO]];
    return round_bf16((decode_e2m1(code) * d) / m.scale);
  }
  if (!P.q_dense) return 0.0f;
  const uint8_t b = P.q[(size_t)row * Kp + k];
  return round_bf16(lut[(m.tag == TAG_E5M2 ? 256 : 0) + b] / m.scale);
}

template <int MI>
__global__ void __launch_bounds__(NTHREADS)
mixed_gemm_kernel(Operand A, Operand B, void* __restrict__ out, float* __restrict__ partial,
                  int out_f32, int Kp, int bk, int nk, int splits) {
  constexpr int BM = 16 * MI;
  __shared__ float lut[512];  // fp8 byte -> f32: [0, 256) E4M3, [256, 512) E5M2
  __shared__ float As[KC][BM + 1];
  __shared__ float Bs[KC][BN + 1];
  __shared__ RowMeta metaA[BM];
  __shared__ RowMeta metaB[BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  for (int b = tid; b < 256; b += NTHREADS) {
    lut[b] = fp8_to_float((uint8_t)b, __NV_E4M3);
    lut[256 + b] = fp8_to_float((uint8_t)b, __NV_E5M2);
  }
  const int tm = tid / 16, tn = tid % 16;
  float acc[MI][BN / 16];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.0f;

  const int kb0 = (int)((long long)nk * z / splits);
  const int kb1 = (int)((long long)nk * (z + 1) / splits);
  for (int kb = kb0; kb < kb1; ++kb) {
    __syncthreads();  // the previous chunk's loads are done with the metadata
    if (tid < BM) metaA[tid] = row_meta(A, m0 + tid, kb, nk);
    else if (tid >= 128 && tid < 128 + BN) metaB[tid - 128] = row_meta(B, n0 + tid - 128, kb, nk);
    __syncthreads();
    for (int kc = 0; kc < bk; kc += KC) {
      const int kbase = kb * bk + kc;
      for (int e = tid; e < BM * KC; e += NTHREADS) {
        const int r = e / KC, kk = e % KC;
        As[kk][r] = kc + kk < bk ? decode(A, metaA[r], m0 + r, kbase + kk, Kp, lut) : 0.0f;
      }
      for (int e = tid; e < BN * KC; e += NTHREADS) {
        const int r = e / KC, kk = e % KC;
        Bs[kk][r] = kc + kk < bk ? decode(B, metaB[r], n0 + r, kbase + kk, Kp, lut) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[MI], b[BN / 16];
#pragma unroll
        for (int i = 0; i < MI; ++i) a[i] = As[kk][tm + 16 * i];
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) b[j] = Bs[kk][tn + 16 * j];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

  const int M = A.rows, N = B.rows;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = m0 + tm + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tn + 16 * j;
      if (col >= N) continue;
      const size_t o = (size_t)row * N + col;
      if (splits > 1) partial[(size_t)z * M * N + o] = acc[i][j];
      else if (out_f32) ((float*)out)[o] = acc[i][j];
      else ((__nv_bfloat16*)out)[o] = f2bf(acc[i][j]);
    }
  }
}

// Sums the split-K partials in split order and casts once.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                     int out_f32, size_t mn, int splits) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + o];
  if (out_f32) ((float*)out)[o] = s;
  else ((__nv_bfloat16*)out)[o] = f2bf(s);
}

extern "C" int mixed_gemm_launch(
    const void* a_q, const void* a_bf, const void* a_nib, const void* a_ms, const void* a_tags,
    const void* a_scales, int a_br, int M, int a_q_dense, int a_bf_dense, int a_nv,
    const void* b_q, const void* b_bf, const void* b_nib, const void* b_ms, const void* b_tags,
    const void* b_scales, int b_br, int N, int b_q_dense, int b_bf_dense, int b_nv,
    void* out, void* workspace, long long workspace_floats, int out_f32, int Kp, int bk,
    void* stream) {
  Operand A{(const uint8_t*)a_q, (const __nv_bfloat16*)a_bf, (const uint8_t*)a_nib,
            (const uint8_t*)a_ms, (const int32_t*)a_tags, (const float*)a_scales,
            a_br, M, a_q_dense, a_bf_dense, a_nv};
  Operand B{(const uint8_t*)b_q, (const __nv_bfloat16*)b_bf, (const uint8_t*)b_nib,
            (const uint8_t*)b_ms, (const int32_t*)b_tags, (const float*)b_scales,
            b_br, N, b_q_dense, b_bf_dense, b_nv};
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int nk = Kp / bk;
  cudaStream_t s = (cudaStream_t)stream;
  const int mi = M <= 16 ? 1 : (M <= 32 ? 2 : 4);
  dim3 grid((N + BN - 1) / BN, (M + 16 * mi - 1) / (16 * mi), 1);
  // Split K only when the output tiles cannot fill the card twice over,
  // and only as far as the caller's f32 workspace holds the partials.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (int)(grid.x * grid.y);
  const size_t mn = (size_t)M * N;
  long long splits = (2LL * sms + tiles - 1) / tiles;
  if (splits > nk) splits = nk;
  if (splits > workspace_floats / (long long)mn) splits = workspace_floats / (long long)mn;
  if (splits < 1) splits = 1;
  grid.z = (unsigned)splits;
  float* part = (float*)workspace;
  const int z = (int)splits;
  if (mi == 1) mixed_gemm_kernel<1><<<grid, NTHREADS, 0, s>>>(A, B, out, part, out_f32, Kp, bk, nk, z);
  else if (mi == 2) mixed_gemm_kernel<2><<<grid, NTHREADS, 0, s>>>(A, B, out, part, out_f32, Kp, bk, nk, z);
  else mixed_gemm_kernel<4><<<grid, NTHREADS, 0, s>>>(A, B, out, part, out_f32, Kp, bk, nk, z);
  err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return (int)err;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, out, out_f32, mn, z);
  return (int)cudaGetLastError();
}
