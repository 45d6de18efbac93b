// mixed_gemm: the mixed-representation block GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mixed_gemm.py:214
// mixed_gemm_blocks: C = A @ B^T over two MixedOperands, every (br, bk)
// block decoded per its tag (E4M3 / E5M2 / BF16 / NVFP4) to its stored
// bf16 value -- bf16(fp8 / scale), the BF16 passthrough, or
// bf16(f32(e2m1 * micro) / scale) -- and accumulated in f32, cast once
// to the output dtype. A lane is read only where a tag names it, so
// compact lanes are never touched. Two paths, chosen by the wrapper from
// M alone (kernels/mixed_gemm.py:gemm_path), take the same arguments:
//
// stream (mixed_gemm_launch; M <= 64: decode, prefill chunks, the f32
// head). Bound on an H100: bytes. Serving GEMMs have a handful of
// activation rows, so the weight's payload (~1 B/element for fp8
// blocks) dominates the traffic and the FLOPs are far below the roof.
// Design: one output tile (16/32/64 rows x 64 columns) per 256-thread
// block, a loop over K in pack-block steps (chunks of 32 inside each
// pack block, so one tag and scale hold per tile row), per-row
// tag/scale/nibble metadata in shared memory, an fp8 decode table in
// shared memory, decoded values staged in shared memory as f32, and f32
// FMAs on CUDA cores (a bf16 x bf16 product is exact in f32, so only the
// order of the sum differs from the plain version). When the output
// tiles alone cannot fill the card (decode against a 4096-wide weight)
// K is split across blocks into an f32 workspace that a second kernel
// sums in a fixed order.
//
// tc (mixed_gemm_tc_launch; M > 64: the training fwd, dgrad and wgrad
// GEMMs, M >= 2048). Bound on an H100: operations (2 M N K at the bf16
// tensor-core peak: 0.486 ms at each training shape of wi). The stored
// values are bf16, and a bf16 x bf16 product is exact in f32, so a bf16
// MMA with f32 accumulation forms the plain version's products; only the
// order of the f32 sums differs. Design, in two kernels on the stream:
//  1. mixed_gemm_decode_kernel writes each operand's stored values, with
//     decode()'s arithmetic (an IEEE division per fp8 element), into a
//     dense bf16 buffer in the caller's workspace, rows padded with zeros
//     to the 128-row tile and K to the 64-deep chunk. It is bound by
//     bytes (~3 B per element moved) and runs once per element.
//  2. mixed_gemm_tc_kernel multiplies the two buffers: a 128 x 128 output
//     tile per 256-thread block (8 warps in a 2 x 4 grid, 64 x 32 per
//     warp, f32 accumulators in registers), mma.sync.m16n8k16 bf16 -> f32
//     fed by ldmatrix.x4 from 144-byte tile rows (the eight rows an
//     ldmatrix reads fall in distinct bank groups), K in 64-deep chunks
//     through a 3-stage cp.async ring (one barrier per chunk), blocks
//     ordered M fastest so the blocks in flight share B's columns in L2.
//     The tensor cores' f32 accumulation does not round to nearest at
//     every add, so every 128-deep partial is promoted into the total
//     with an IEEE add.
// Why not decode inside the GEMM (each chunk in shared memory, through
// per-block 256-entry tables): every output tile that visits a block
// would decode it again (224 times for the activation at the fwd
// shape), and with 8 warps per SM that decode, not the MMAs, bounded
// such a kernel on the card. Decoding once costs the buffers' traffic
// instead (~3 B per element). No wgmma, TMA or warp specialisation yet:
// wgmma would read the tiles through shared-memory descriptors in its
// own layout.
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

// ---------------------------------------------------------------------------
// tc path: decode each operand once to bf16, then a bf16 tensor-core GEMM.
// ---------------------------------------------------------------------------
#define TC_BM 128
#define TC_BN 128
#define TC_KC 64  // K chunk of one pipeline stage
#define TC_LD 72  // bf16 row of a shared tile: 144 B (64 values + 16 B pad)
#define TC_THREADS 256
#define TC_STAGES 3
#define TC_TILE (TC_BM * TC_LD)  // bf16 elements of one operand tile (TC_BN == TC_BM)
#define TC_PROMOTE 2  // chunks (128 K) summed on the tensor cores before an IEEE add

// Stored values of an operand, as decode() computes them, into a dense
// bf16 (Rd, Kd) buffer: Rd rows (the operand's, padded with zero rows to
// the GEMM's tile) by Kd columns (Kp, padded with zeros to the chunk).
// One thread per 8 consecutive elements of a row; where bk and the lanes
// allow (vec), the 8 share one pack block and are read with one load
// of the lane their tag names.
__global__ void __launch_bounds__(TC_THREADS)
mixed_gemm_decode_kernel(Operand P, __nv_bfloat16* __restrict__ out, int Rd, int Kd, int Kp,
                         int bk, int nk, int vec) {
  __shared__ float lut[512];  // fp8 byte -> f32: [0, 256) E4M3, [256, 512) E5M2
  for (int b = threadIdx.x; b < 256; b += TC_THREADS) {
    lut[b] = fp8_to_float((uint8_t)b, __NV_E4M3);
    lut[256 + b] = fp8_to_float((uint8_t)b, __NV_E5M2);
  }
  __syncthreads();
  const unsigned g = blockIdx.x * TC_THREADS + threadIdx.x, per_row = (unsigned)Kd / 8;
  if (g >= (unsigned)Rd * per_row) return;
  const int row = (int)(g / per_row), k0 = (int)(g - (unsigned)row * per_row) * 8;
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
  if (row < P.rows && k0 < Kp) {
    if (vec) {
      const RowMeta m = row_meta(P, row, k0 / bk, nk);
      const size_t e0 = (size_t)row * Kp + k0;
      if (m.tag == TAG_BF16) {
        if (P.bf_dense) o = *reinterpret_cast<const uint4*>(P.bf + e0);
      } else if (m.tag == TAG_NVFP4 && P.nv) {
        const uint2 w = *reinterpret_cast<const uint2*>(P.nib + (size_t)m.nib_row * Kp + k0);
        const uint8_t* by = reinterpret_cast<const uint8_t*>(&w);
        const float d = lut[P.ms[(size_t)row * (Kp / NVFP4_MICRO) + k0 / NVFP4_MICRO]];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ob[e] = f2bf((decode_e2m1((by[e] >> m.nib_shift) & 15) * d) / m.scale);
      } else if (m.tag >= 0 && P.q_dense) {
        const uint2 w = *reinterpret_cast<const uint2*>(P.q + e0);
        const uint8_t* by = reinterpret_cast<const uint8_t*>(&w);
        const float* t = lut + (m.tag == TAG_E5M2 ? 256 : 0);
#pragma unroll
        for (int e = 0; e < 8; ++e) ob[e] = f2bf(t[by[e]] / m.scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e;
        if (k < Kp) ob[e] = f2bf(decode(P, row_meta(P, row, k / bk, nk), row, k, Kp, lut));
      }
    }
  }
  *reinterpret_cast<uint4*>(out + (size_t)row * Kd + k0) = o;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tc_store2(void* out, int out_f32, int M, int N, int row, int col,
                                          float v0, float v1) {
  if (row >= M || col >= N) return;
  const size_t o = (size_t)row * N + col;
  const bool pair = col + 1 < N && (N & 1) == 0;  // 2-element aligned store
  if (out_f32) {
    float* p = (float*)out + o;
    if (pair) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    else {
      p[0] = v0;
      if (col + 1 < N) p[1] = v1;
    }
  } else {
    __nv_bfloat16* p = (__nv_bfloat16*)out + o;
    if (pair) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    else {
      p[0] = f2bf(v0);
      if (col + 1 < N) p[1] = f2bf(v1);
    }
  }
}

// C = A @ B^T on decoded operands: A (>= M rows, padded to the tile) and
// B (>= N rows) of Kd columns each, both bf16 row-major, Kd % TC_KC == 0.
__global__ void __launch_bounds__(TC_THREADS)
mixed_gemm_tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    void* __restrict__ out, int out_f32, int M, int N, int Kd) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [stage][A, B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * TC_BM, n0 = blockIdx.y * TC_BN;
  const int nchunks = Kd / TC_KC;
  // Copies of a chunk: each tile is 128 rows of TC_KC / 8 16-byte
  // pieces; a thread copies pieces tid, tid + 256, ... of each, which lie
  // TC_ROWS rows apart.
  constexpr int PIECES = TC_KC / 8, TC_ROWS = TC_THREADS / PIECES;
  const __nv_bfloat16* ga = A + (size_t)(m0 + tid / PIECES) * Kd + (tid % PIECES) * 8;
  const __nv_bfloat16* gb = B + (size_t)(n0 + tid / PIECES) * Kd + (tid % PIECES) * 8;
  const int so = (tid / PIECES) * TC_LD + (tid % PIECES) * 8;  // its first piece in a tile
  auto issue = [&](int c) {
    __nv_bfloat16* As = tiles + (c % TC_STAGES) * 2 * TC_TILE;
    const size_t k = (size_t)c * TC_KC;
#pragma unroll
    for (int i = 0; i < TC_BM / TC_ROWS; ++i) {
      cp_async16(As + so + i * TC_ROWS * TC_LD, ga + k + (size_t)i * TC_ROWS * Kd);
      cp_async16(As + TC_TILE + so + i * TC_ROWS * TC_LD, gb + k + (size_t)i * TC_ROWS * Kd);
    }
  };

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.0f;

#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) {
    if (c < nchunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // chunk c has landed for every thread; chunk c - 1 is consumed
    if (c + TC_STAGES - 1 < nchunks) issue(c + TC_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* As = tiles + (c % TC_STAGES) * 2 * TC_TILE;
    const __nv_bfloat16* Bs = As + TC_TILE;
#pragma unroll
    for (int ks = 0; ks < TC_KC; ks += 16) {
      uint32_t bf[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], Bs + (wn * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * TC_LD + ks +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, As + (wm * 64 + mi * 16 + (lane & 15)) * TC_LD + ks + (lane >> 4) * 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(part[mi][ni], af, bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    if (c % TC_PROMOTE == TC_PROMOTE - 1 || c == nchunks - 1) {
      // The tensor cores' f32 accumulation does not round to nearest at
      // every add (unpromoted, an element of a K = 4000 product with
      // outliers left the 1e-5 sum|a||b| bound); each 128-deep partial is
      // promoted into the f32 total with an IEEE add.
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += part[i][j][e];
            part[i][j][e] = 0.0f;
          }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = m0 + wm * 64 + mi * 16 + (lane >> 2);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      tc_store2(out, out_f32, M, N, row, col, acc[mi][ni][0], acc[mi][ni][1]);
      tc_store2(out, out_f32, M, N, row + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

static cudaError_t tc_decode_launch(const Operand& P, __nv_bfloat16* out, int Rd, int Kd, int Kp,
                                    int bk, cudaStream_t s) {
  // One load per 8 elements where the 8 share a pack block and every
  // lane the tags may name is aligned for it.
  const int vec = bk % 8 == 0 && Kp % 8 == 0 && (!P.q_dense || aligned16(P.q)) &&
                  (!P.bf_dense || aligned16(P.bf)) && (!P.nv || aligned16(P.nib));
  const unsigned blocks = (unsigned)(((long long)Rd * (Kd / 8) + TC_THREADS - 1) / TC_THREADS);
  mixed_gemm_decode_kernel<<<blocks, TC_THREADS, 0, s>>>(P, out, Rd, Kd, Kp, bk, Kp / bk, vec);
  return cudaGetLastError();
}

// The workspace holds the two decoded operands: (Rd_A + Rd_B) x Kd bf16,
// Rd the rows rounded up to 128 and Kd = Kp rounded up to TC_KC.
extern "C" int mixed_gemm_tc_launch(
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
  const int Rda = (M + TC_BM - 1) / TC_BM * TC_BM, Rdb = (N + TC_BN - 1) / TC_BN * TC_BN;
  const int Kd = (Kp + TC_KC - 1) / TC_KC * TC_KC;
  if (2 * workspace_floats < (long long)(Rda + Rdb) * Kd ||
      (long long)(Rda > Rdb ? Rda : Rdb) * (Kd / 8) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* da = (__nv_bfloat16*)workspace;
  __nv_bfloat16* db = da + (size_t)Rda * Kd;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = tc_decode_launch(A, da, Rda, Kd, Kp, bk, s);
  if (err == cudaSuccess) err = tc_decode_launch(B, db, Rdb, Kd, Kp, bk, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)TC_STAGES * 2 * TC_TILE * sizeof(__nv_bfloat16);
  err = cudaFuncSetAttribute(mixed_gemm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((unsigned)(Rdb / TC_BN) > 65535u) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(Rda / TC_BM, Rdb / TC_BN);  // M fastest: the blocks in flight share B's columns
  mixed_gemm_tc_kernel<<<grid, TC_THREADS, smem, s>>>(da, db, out, out_f32, M, N, Kd);
  return (int)cudaGetLastError();
}
