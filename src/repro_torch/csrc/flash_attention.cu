// flash_attention: the attention forward kernel for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:113
// flash_attention_fwd: softmax(q k^T * d^-0.5, masked) v with an online
// softmax over key tiles, causal masking by true position
// (k_pos <= q_offset[bh] + q_row) or none, f32 or bf16 in, q's dtype
// out. On the TPU the key axis was a sequential grid dimension carrying
// (m, l, acc) in VMEM; here it is a loop inside the thread block.
//
// Bound on an H100: operations for long sequences (4 d flops per visible
// (query, key) pair: 2 d for q k^T, 2 d for p v), bytes for short
// chunks against a cache. Design (a first, simple version): one thread
// block of 128 threads per (row bh, 64-query tile); q is staged once in
// shared memory, transposed, as f32; each 64-key tile of k (transposed)
// and then v (row-major) goes through one shared f32 buffer. Both
// products run on CUDA cores in f32 with register tiles of 4 x 8 scores
// and 4 x d/8 outputs per thread: f32 inputs must not meet TF32, and p
// stays f32 as in the reference (a bf16 p for the tensor cores would
// move each weight by ~2^-9). The loop stops after the tile holding the
// tile's last visible key.
//
// Layout: q and out (B, S, H, d) or folded (BH, S, d), k and v (B, T,
// H / G, d) or folded, all read in place through element strides: query
// head h reads kv head h / G, so GQA needs no repeated copy of k and v.
//
// Numerics: m starts at -1e30 and masked scores are -1e30, as in the
// reference; a row with no visible key (q_offset + row < 0) scores 0 on
// every real key instead, which is the reference's softmax over T equal
// scores: the mean of v over all T keys. Keys past T never count. The
// output is acc / max(l, 1e-30). expf (not __expf), IEEE division, no
// fast-math; sums run in another order than the plain version's
// matmuls, so the two agree within f32 summation order.
#include "common.cuh"

#define FA_THREADS 128
#define FA_BQ 64
#define FA_BK 64
#define FA_LDP 68  // padded row of the transposed p tile: conflict-free stores
#define FA_NEG -1e30f

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return bf2f(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return f2bf(v); }

// 64 rows x D of a row-strided matrix (rows from r0, zero past nrows)
// into shared memory as f32: transposed (dst[c * 64 + r]) with
// consecutive threads on consecutive rows, or row-major (dst[r * D + c])
// with consecutive threads along a row. 16-byte loads.
template <typename T, int D, bool kTrans>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long rs, int r0,
                                          int nrows, float* __restrict__ dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += FA_THREADS) {
    const int r = kTrans ? idx % 64 : idx / CH;
    const int ch = kTrans ? idx / 64 : idx % CH;
    float vals[VEC];
    if (r0 + r < nrows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + ch * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = to_f32<T>(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.0f;
    }
    if (kTrans) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[(ch * VEC + i) * 64 + r] = vals[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(dst + r * D + ch * VEC + i) =
            make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ offs,
                       T* __restrict__ out, int H, int G, int S, int T_, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, int causal, float scale) {
  static_assert(D % 32 == 0, "the p v tile gives each thread d/8 columns in 32-wide steps");
  constexpr int DC = D / 32;  // float4 column groups per thread in p v
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // D x 64
  float* kv = qT + D * 64;                      // k^T (D x 64), then v (64 x D)
  float* pT = kv + D * 64;                      // 64 keys x FA_LDP

  const int nq = (S + FA_BQ - 1) / FA_BQ;
  // Heaviest (latest) query tiles first: causal work grows with the row.
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = (int)(blockIdx.x / nq);
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;  // 16 row groups of 4, 8 column groups
  const int q0 = qt * FA_BQ;
  const int off = offs[bh];

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * k_sb + (h / G) * k_sh;
  T* ob = out + b * q_sb + h * q_sh;

  load_tile<T, D, true>(qb, q_ss, q0, S, qT);

  // Keys this tile must visit: through its last visible position, or all
  // T when a row has none (it averages over every key) or not causal.
  const int q_last = min(q0 + FA_BQ, S) - 1;
  int kend = T_;
  if (causal && off + q0 >= 0) kend = min(T_, off + q_last + 1);

  int rowpos[4];
  bool empty[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rowpos[i] = off + q0 + rg * 4 + i;
    empty[i] = causal && rowpos[i] < 0;
  }
  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();  // the previous tile's v and p are consumed
    load_tile<T, D, true>(kb, k_ss, k0, T_, kv);
    __syncthreads();

    // s = q k^T for 4 rows x 8 keys (keys cg*4 + j and 32 + cg*4 + j).
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(qT + kk * 64 + rg * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(kv + kk * 64 + cg * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(kv + kk * 64 + 32 + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += av[i] * bv[j];
    }

    // Mask, online softmax statistics (8 lanes share a row group).
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j >> 2) * 32 + cg * 4 + (j & 3);
        float sc = s[i][j] * scale;
        if (key >= T_) sc = FA_NEG;
        else if (empty[i]) sc = 0.0f;
        else if (causal && key > rowpos[i]) sc = FA_NEG;
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j >> 2) * 32 + cg * 4 + (j & 3);
      *reinterpret_cast<float4*>(pT + c * FA_LDP + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();  // k^T is consumed, p is written
    load_tile<T, D, false>(vb, k_ss, k0, T_, kv);
    __syncthreads();

    // acc = acc * corr + p v (columns cg*4 + 32*c4 + j).
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pT + j * FA_LDP + rg * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c4 = 0; c4 < DC; ++c4) {
        const float4 w = *reinterpret_cast<const float4*>(kv + j * D + c4 * 32 + cg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c4 * 4 + 0] += pv[i] * w.x;
          acc[i][c4 * 4 + 1] += pv[i] * w.y;
          acc[i][c4 * 4 + 2] += pv[i] * w.z;
          acc[i][c4 * 4 + 3] += pv[i] * w.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c4 = 0; c4 < DC; ++c4)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ob[(long long)row * q_ss + c4 * 32 + cg * 4 + j] =
            from_f32<T>(acc[i][c4 * 4 + j] / den);
  }
}

template <typename T, int D>
static int launch_typed(const void* q, const void* k, const void* v, const int* off, void* out,
                        int B, int H, int G, int S, int T_, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                        int causal, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D * 64 + 64 * FA_LDP) * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((S + FA_BQ - 1) / FA_BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, off, (T*)out, H, G, S, T_, q_sb, q_sh, q_ss, k_sb,
      k_sh, k_ss, causal, scale);
  return (int)cudaGetLastError();
}

// q, k, v, out: element strides per batch (sb), head (sh) and row (ss);
// the last dimension is contiguous. off: (B * H,) int32 query offsets.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* off, void* out, int B, int H, int G, int S,
                                      int T_, int d, long long q_sb, long long q_sh,
                                      long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, int causal, float scale, int bf16,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* o = (const int*)off;
#define FA_CASE(TY, DD)                                                                       \
  if (d == DD)                                                                                \
    return launch_typed<TY, DD>(q, k, v, o, out, B, H, G, S, T_, q_sb, q_sh, q_ss, k_sb, k_sh, \
                                k_ss, causal, scale, st);
  if (bf16) {
    FA_CASE(__nv_bfloat16, 32)
    FA_CASE(__nv_bfloat16, 64)
    FA_CASE(__nv_bfloat16, 128)
  } else {
    FA_CASE(float, 32)
    FA_CASE(float, 64)
    FA_CASE(float, 128)
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
