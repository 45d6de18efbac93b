// flash_attention: the attention forward kernel for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:113
// flash_attention_fwd: softmax(q k^T * d^-0.5, masked) v with an online
// softmax over key tiles, causal masking by true position
// (k_pos <= q_offset[bh] + q_row) or none, f32 or bf16 in, q's dtype
// out. On the TPU the key axis was a sequential grid dimension carrying
// (m, l, acc) in VMEM; here it is a loop inside the thread block.
//
// Layout: q and out (B, S, H, d) or folded (BH, S, d), k and v (B, T,
// H / G, d) or folded, all read in place: query head h reads kv head
// h / G, so GQA needs no repeated copy of k and v.
//
// Numerics, both routes: m starts at -1e30 and masked scores are -1e30,
// as in the reference; a row with no visible key (causal, q_offset + row
// < 0) scores 0 on every real key instead, which is the reference's
// softmax over T equal scores: the mean of v over all T keys. Keys past T
// never count. The output is acc / max(l, 1e-30) by IEEE division, no
// fast-math, no atomics: a call repeats bit for bit. Sums run in another
// order than the plain version's matmuls, so the two agree within f32
// summation order (chip_smoke.py's flash_tol: 1e-5 max|v| plus one ulp
// of the output).
//
// Bounds on an H100 (chip_smoke.py counts them from each call's shapes):
// operations for long sequences, 4 d flops per visible (query, key) pair
// (2 d for q k^T, 2 d for p v) at 989 TFLOP/s bf16: 0.0174 ms at 2 x 1024,
// 0.556 ms at 1 x 8192 (llama3-8b's 32 q / 8 kv heads, dh 128, causal);
// bytes for a short chunk against a cache (q and out once, the K/V rows
// each slot reads once, at 3.35 TB/s): 0.00169 ms for the engine's 4-slot
// chunk of 32 queries against 512 positions. The wgmma route's own
// ceiling is 6 d flops a pair (p v runs twice, below): 0.026 and 0.834
// ms at the first two shapes.
//
// Two routes, picked by the wrapper from dtype and d alone
// (kernels/flash_attention.py:flash_route):
//
// wgmma (flash_attention_wgmma_launch; bf16, d 64 or 128). One thread
// block of three warpgroups per (row bh, 128-query tile), the tiles with
// the most keys launched first.
//  - Producer (warpgroup 0, 24 registers; one thread issues). The TMA
//    loads the q tile once and streams 128-key tiles of k, then v, through
//    a ring of FW_STAGES stages, each with its own `kfull` / `vfull`
//    mbarrier and an `empty` one that the consumers' warps arrive on. Every
//    tile is bf16 with the 128-byte swizzle, a 256-B row as two 64-column
//    boxes. The maps are 3-D (columns, rows, batch; tma.cuh:tma_map_3d),
//    so rows past S or T arrive as zeros, never as the next batch's rows
//    (a NaN there would give p = 0 times NaN).
//  - Consumers (warpgroups 1 and 2, 240 registers; each owns 64 query
//    rows). s = q k^T: m64n128k16 wgmmas with both operands in shared
//    memory, k read K-major in place. bf16 products are exact in f32, so
//    the scores are the plain version's up to f32 summation order; the
//    scale is applied after the product. Online softmax in registers on
//    the accumulator layout (row max and sum over the quad by shuffles),
//    in base 2: p = 2^(s c - m c) with c = d^-0.5 log2 e, the scale and
//    the subtraction of the rounded m c in one FFMA (one rounding, at most
//    |s c| 2^-24, the relative error in p that expf of an f32 score has),
//    and o, l rescaled by 2^(m_old c - m_new c) from the same rounded
//    values, so that the tiles' weights stay consistent; 2^x by
//    ex2.approx.ftz.f32 (about 2^-22; a weight below 2^-126 of its row's
//    largest flushes to 0); both took time off the call against exp2f
//    after a separate scale, with copies of this source run side by side
//    on an H100. The key loop is two loops: tiles with no masked key,
//    then the diagonal and ragged tiles that apply the mask
//    (no branch around code that touches the wgmma registers: ptxas
//    serialized fp8_gemm's wgmmas for that, C7518).
//  - o += p v with p split into two bf16 terms, hi = bf16(p) and lo =
//    bf16(p - hi) (p - hi is exact in f32): two m64nDk16 wgmmas a 16-key
//    step, A from registers (the s accumulator packed in pairs is the A
//    fragment, wgmma.cuh), v read through the transpose bit in place. A
//    single bf16 p moves each weight by up to 2^-9 and misses flash_tol
//    by an order of magnitude (tests/test_torch_flash_attention.py
//    emulates both on the CPU); hi + lo keeps p to ~2^-17. o is rescaled
//    in registers and accumulates in the wgmmas' f32 registers, with no
//    per-tile promotion by IEEE adds: the parity gate holds without one
//    (largest err / tol 0.994 on the card, the bf16 output's own ulp).
// Limiter, seen on an H100 by ablation (kernels/flash_ablation.py:
// copies of this source with one part taken out, timed beside it in
// turns): the wgmmas. Taking out the lo MMAs, a third of the MMA work,
// takes most of a third off the time; a cheaper exp takes nothing off.
// Neither issuing the next tile's q k^T before this tile's softmax (with
// a third K/V stage) nor, on top of it, a ping-pong of the two
// warpgroups' wgmma issue by named barriers (FlashAttention-3's
// schedules) moved the time much in side-by-side runs, so the simpler
// loop stays: per MMA flop the kernel runs within ~15% of SDPA's rate on
// the same card, and p v twice gives it 1.5x the MMA work. A faster
// route needs fewer MMAs for p v at the same error.
//
// cuda_core (flash_attention_launch; f32, whose products must not meet
// TF32 or bf16, and d = 32). A first, simple design: one thread block of
// 128 threads per (row bh, 64-query tile); q staged once in shared memory,
// transposed, as f32; each 64-key tile of k (transposed) and then v
// (row-major) through one shared f32 buffer. Both products on CUDA cores
// in f32 with register tiles of 4 x 8 scores and 4 x d/8 outputs per
// thread, expf (not __expf). The loop stops after the tile holding the
// tile's last visible key.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// cuda_core route
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------
#define FW_BQ 128      // query rows of a thread block: two consumer warpgroups of 64
#define FW_BK 128      // keys of a K / V tile
#define FW_STAGES 2    // K / V tiles in the TMA ring
#define FW_THREADS 384  // producer warpgroup + two consumer warpgroups
#define FW_NEG -1e30f

// 2^x by the MUFU instruction: relative error about 2^-22; a subnormal
// result flushes to 0 (a weight below 2^-126 of its row's largest).
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one thread block: the q tile, then the ring's stages
// (k's tile, then v's). A tile is CH boxes of 64 columns, each rows x
// 128 B, swizzled.
template <int D>
struct FwSmem {
  static constexpr int CH = D / 64;
  static constexpr int Q_BYTES = FW_BQ * D * 2;
  static constexpr int KV_BYTES = FW_BK * D * 2;  // one of k or v
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int TOTAL = 1024 + Q_BYTES + FW_STAGES * STAGE;
};

// o (64 x D, this warpgroup's rows) += p v over key tile t: s = q k^T by
// wgmma, masked (kMask: the causal diagonal, rows with no visible key,
// keys past T), the online softmax update of m, l and o in base 2, then
// p v as hi + lo. s, ph and pl live in the caller so that no
// tile re-initialises them.
template <int D, bool kMask>
__device__ __forceinline__ void fw_tile(float (&o)[D / 2], float (&s)[64], uint32_t (&ph)[8][4],
                                        uint32_t (&pl)[8][4], float (&m)[2], float (&l)[2],
                                        int t, uint32_t q_addr, uint32_t ring_addr,
                                        uint64_t* kfull, uint64_t* vfull, uint64_t* empty,
                                        int T_, int causal, int pos0, int pos1, float sl2,
                                        int qd, int lt) {
  using L = FwSmem<D>;
  const int slot = t % FW_STAGES;
  const uint32_t par = (uint32_t)(t / FW_STAGES) & 1u;
  const uint32_t k_addr = ring_addr + slot * L::STAGE, v_addr = k_addr + L::KV_BYTES;

  mbar_wait(&kfull[slot], par);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t c = (kk >> 2), w = (kk & 3) * 32;
    wgmma_bf16_ss_n128(s, w_desc(q_addr + c * (FW_BQ * 128) + w, 16, 1024),
                       w_desc(k_addr + c * (FW_BK * 128) + w, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // Element 4 i + e is row (e >> 1) (pos0 or pos1), key t * FW_BK + 8 i +
  // 2 qd + (e & 1). m is kept in the units of q k^T; the scale to base 2
  // joins the subtraction of the max in one FFMA.
  float mx[2] = {FW_NEG, FW_NEG};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e];
      if (kMask) {
        const int key = t * FW_BK + 8 * i + 2 * qd + (e & 1);
        const int pos = (e >> 1) ? pos1 : pos0;
        x = key >= T_ ? FW_NEG : (causal && pos < 0) ? 0.0f : (causal && key > pos) ? FW_NEG : x;
      }
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2], ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // corr from the two scaled maxima as rounded, the values that the
    // tiles' p subtract (no contraction into an FFMA).
    const float m_new = fmaxf(m[r], mx[r]);
    ms[r] = __fmul_rn(m_new, sl2);
    corr[r] = fw_exp2(__fmul_rn(m[r], sl2) - ms[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fw_exp2(fmaf(s[i], sl2, -ms[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
  // p as two bf16 terms, packed in pairs into the A fragments of the 16-key
  // steps: a[kk][j] = (s[8 kk + 2 j], s[8 kk + 2 j + 1]).
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      ph[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
    }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

  mbar_wait(&vfull[slot], par);
  fence_regs(o);
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = w_desc(v_addr + kk * (16 * 128), FW_BK * 128, 1024);
    if constexpr (D == 128) {
      wgmma_bf16_rs_n128(o, ph[kk], dv, 1);
      wgmma_bf16_rs_n128(o, pl[kk], dv, 1);
    } else {
      wgmma_bf16_rs_n64(o, ph[kk], dv, 1);
      wgmma_bf16_rs_n64(o, pl[kk], dv, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(ph);
  fence_regs(pl);
  __syncwarp();
  if ((lt & 31) == 0) mbar_arrive(&empty[slot]);
}

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const int* __restrict__ offs, __nv_bfloat16* __restrict__ out,
                             int BH, int H, int G, int S, int T_, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sh, int causal,
                             float sl2) {
  using L = FwSmem<D>;
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  // qfull: the q tile landed; kfull / vfull: a stage's k / v tile landed;
  // empty: the stage's wgmmas are done (four warps per active consumer).
  __shared__ __align__(8) uint64_t qfull, kfull[FW_STAGES], vfull[FW_STAGES], empty[FW_STAGES];
  // The swizzle patterns repeat every 1024 B: align the tiles to it.
  unsigned char* qs = fw_smem + ((1024 - (smem_u32(fw_smem) & 1023)) & 1023);
  unsigned char* ring = qs + L::Q_BYTES;

  // Row bh fastest, so that the q tiles with the most keys (the latest)
  // of every row go first, and the q heads of one kv head run together.
  const int nq = (S + FW_BQ - 1) / FW_BQ;
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int qt = nq - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * FW_BQ;
  const int off = offs[bh];
  // Keys this tile must visit: through its last visible position, or all
  // T when a row has none (it averages over every key) or not causal.
  const int q_last = min(q0 + FW_BQ, S) - 1;
  int kend = T_;
  if (causal && off + q0 >= 0) kend = min(T_, off + q_last + 1);
  const int ntiles = (kend + FW_BK - 1) / FW_BK;
  const int nwg = S - q0 > 64 ? 2 : 1;  // consumer warpgroups with a row below S
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    mbar_init(&qfull, 1);
    for (int i = 0; i < FW_STAGES; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&vfull[i], 1);
      mbar_init(&empty[i], 4 * nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (lt == 0) {
      const int qx = h * (int)q_sh, kx = (h / G) * (int)k_sh;
      mbar_expect_tx(&qfull, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
        tma_load_3d(qs + c * (FW_BQ * 128), &qmap, qx + 64 * c, q0, b, &qfull);
      for (int t = 0; t < ntiles; ++t) {
        const int slot = t % FW_STAGES;
        if (t >= FW_STAGES) mbar_wait(&empty[slot], (uint32_t)(t / FW_STAGES - 1) & 1u);
        unsigned char* st = ring + slot * L::STAGE;
        mbar_expect_tx(&kfull[slot], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          tma_load_3d(st + c * (FW_BK * 128), &kmap, kx + 64 * c, t * FW_BK, b, &kfull[slot]);
        mbar_expect_tx(&vfull[slot], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          tma_load_3d(st + L::KV_BYTES + c * (FW_BK * 128), &vmap, kx + 64 * c, t * FW_BK, b,
                      &vfull[slot]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    if (cw < nwg) {
      const int w = lt >> 5, g = (lt & 31) >> 2, qd = lt & 3;
      const int r0 = q0 + 64 * cw + 16 * w + g;  // this thread's rows: r0, r0 + 8
      const int pos0 = off + r0, pos1 = pos0 + 8;
      // Tiles below every row's diagonal with no key past T take no mask.
      const int pmin = off + q0 + 64 * cw;
      int nfull = T_ / FW_BK;
      if (causal) nfull = pmin >= 0 ? min((pmin + 1) / FW_BK, nfull) : 0;
      nfull = min(nfull, ntiles);
      float o[D / 2], s[64], m[2] = {FW_NEG, FW_NEG}, l[2] = {0.0f, 0.0f};
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ph[i][j] = pl[i][j] = 0u;
      const uint32_t q_addr = smem_u32(qs) + cw * (64 * 128), ring_addr = smem_u32(ring);
      mbar_wait(&qfull, 0);
      int t = 0;
      for (; t < nfull; ++t)
        fw_tile<D, false>(o, s, ph, pl, m, l, t, q_addr, ring_addr, kfull, vfull, empty, T_,
                          causal, pos0, pos1, sl2, qd, lt);
      for (; t < ntiles; ++t)
        fw_tile<D, true>(o, s, ph, pl, m, l, t, q_addr, ring_addr, kfull, vfull, empty, T_,
                         causal, pos0, pos1, sl2, qd, lt);

      const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
      __nv_bfloat16* ob = out + b * q_sb + h * q_sh;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * qd;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 y =
              __floats2bfloat162_rn(o[4 * i + 2 * r] / den[r], o[4 * i + 2 * r + 1] / den[r]);
          if (r0 + 8 * r < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r0 + 8 * r) * q_ss + col) = y;
        }
      }
    }
  }
}

template <int D>
static cudaError_t fw_launch(unsigned grid, cudaStream_t st, const CUtensorMap& qmap,
                             const CUtensorMap& kmap, const CUtensorMap& vmap, const int* off,
                             void* out, int BH, int H, int G, int S, int T_, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sh, int causal,
                             float sl2) {
  static bool allowed = false;  // the >48 KB opt-in, once per instantiation
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               FwSmem<D>::TOTAL);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  flash_attention_wgmma_kernel<D><<<grid, FW_THREADS, FwSmem<D>::TOTAL, st>>>(
      qmap, kmap, vmap, off, (__nv_bfloat16*)out, BH, H, G, S, T_, q_sb, q_sh, q_ss, k_sh,
      causal, sl2);
  return cudaGetLastError();
}

// Dynamic shared memory of one wgmma-route thread block at head dim d, in
// bytes (0: not a head dim of the route).
extern "C" int flash_attention_wgmma_smem(int d) {
  return d == 128 ? FwSmem<128>::TOTAL : d == 64 ? FwSmem<64>::TOTAL : 0;
}

// The wgmma route: bf16 q, k, v with d 64 or 128; the arguments of
// flash_attention_launch. Rows of q, k and v are read as 3-D TMA tensors
// (columns = the row stride, rows, batch), so every stride must be a
// multiple of 16 bytes and each batch's rows must not overlap.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            const void* off, void* out, int B, int H, int G,
                                            int S, int T_, int d, long long q_sb, long long q_sh,
                                            long long q_ss, long long k_sb, long long k_sh,
                                            long long k_ss, int causal, float scale, int bf16,
                                            void* stream) {
  if (!bf16 || (d != 64 && d != 128) || S <= 0 || T_ <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  if ((q_ss | q_sb | k_ss | k_sb) & 7) return (int)cudaErrorInvalidValue;
  const long long nq = (S + FW_BQ - 1) / FW_BQ, BH = (long long)B * H;
  if (BH * nq > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t e = tma_map_3d(&qmap, bf, q, B, S, (int)q_ss, 2 * (size_t)q_ss, 2 * (size_t)q_sb,
                             64, FW_BQ, sw);
  if (e == cudaSuccess)
    e = tma_map_3d(&kmap, bf, k, B, T_, (int)k_ss, 2 * (size_t)k_ss, 2 * (size_t)k_sb, 64,
                   FW_BK, sw);
  if (e == cudaSuccess)
    e = tma_map_3d(&vmap, bf, v, B, T_, (int)k_ss, 2 * (size_t)k_ss, 2 * (size_t)k_sb, 64,
                   FW_BK, sw);
  if (e != cudaSuccess) return (int)e;
  // Scores to base 2: p = 2^(s c - m c) with c = d^-0.5 log2 e.
  const float sl2 = (float)((double)scale * 1.4426950408889634);
  const cudaStream_t st = (cudaStream_t)stream;
  const int* o = (const int*)off;
  if (d == 128)
    e = fw_launch<128>((unsigned)(BH * nq), st, qmap, kmap, vmap, o, out, (int)BH, H, G, S, T_,
                       q_sb, q_sh, q_ss, k_sh, causal, sl2);
  else
    e = fw_launch<64>((unsigned)(BH * nq), st, qmap, kmap, vmap, o, out, (int)BH, H, G, S, T_,
                      q_sb, q_sh, q_ss, k_sh, causal, sl2);
  return (int)e;
}
