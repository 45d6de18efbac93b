// fp8_gemm: the per-block-scaled fp8 GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fp8_gemm.py:59 fp8_gemm:
// C = sum_kb (A_q[:, kb] B_q[kb, :]) * scale with A_q (M, K) and B_q
// (K, N) fp8 payloads (E4M3 or E5M2, each operand its own), one f32 scale
// per (bm, bk) block of A and (bk, bn) block of B, an f32 partial per K
// block, f32 accumulation across K blocks, one cast to bf16 or f32 at
// the end.
//
// Promotion. A K block's partial joins the total as acc += (part * ra) *
// rb, with ra = 1 / sa and rb = 1 / sb the IEEE reciprocals of its two
// block scales: the two scales are applied one after the other, never as
// one product. sa * sb overflows f32 when both blocks hold tiny values
// (N(0,1) * 1e-18 gives sa ~ 1e20), and 1 / (sa * sb) would then zero the
// product, where the plain version (and the JAX package's XLA reference)
// dequantizes element by element. An Inf scale gives a reciprocal of 0,
// so its block adds 0, as a / Inf does there.
//
// Bound on an H100: operations (2 M N K; the fp8 tensor-core peak is
// 1,979 TFLOP/s), bytes only for skinny M. Two routes, picked by the
// wrapper from the block alone (kernels/fp8_gemm.py:fp8_gemm_route):
//
// wgmma (fp8_gemm_wgmma_launch; bm % 64 == 0, bn % 128 == 0, bk % 128 ==
// 0). The MMA type is f16: every E4M3 and E5M2 value is exact in f16
// (E4M3 spans 2^-9..448, E5M2 is a truncated f16) and an f16 x f16
// product is exact in f32, so an f16 wgmma with f32 accumulators forms
// the plain version's products and only the order of the f32 sums
// differs. Hopper's fp8 MMA is not used: it keeps fewer accumulator bits
// than f32, and for 8-bit types it wants both operands K-major while B
// arrives N-major. Ceiling of this design: 2 M N K at the f16 peak (989
// TFLOP/s), twice the fp8 bound. Design: one 128 x 128 output tile per
// thread block of three warpgroups, in 64-deep K stages.
//  - Converter (warpgroup 0, 56 registers). Its thread 0 keeps TMA copies
//    of the fp8 bytes W_AHEAD stages ahead in a ring of W_STAGES (A: a
//    64 B x 128-row box of its K-major rows; B: a 128 B x 64-row box of
//    its N-major rows), each stage completing on its `full` mbarrier. The
//    warpgroup converts each landed stage's B fp8 -> f16 (cvt.rn.f16x2.
//    {e4m3,e5m2}x2, exact) into one of W_HBUF buffers, in the N-major
//    layout that wgmma's shared-memory descriptor reads through its
//    transpose bit, with the 128-byte swizzle (16-B chunk c of a 128-B row
//    r at c ^ (r & 7)), once the buffer's last wgmmas are done (`hempty`),
//    and publishes it (`hfull`).
//  - MMA warpgroups (1 and 2, 216 registers; each owns a 64 x 128 slab of
//    the tile). A comes from registers: each thread reads its two rows'
//    16 fp8 bytes of a stage (one stage ahead, while the wgmmas run) and
//    converts them into the m16n8k16 fragments of the stage's four
//    16-deep steps, under a permutation of k within the stage that A and
//    B share (w_b_row), so that A never passes through shared memory as
//    f16. Four m64n128k16 wgmmas a stage into `part`, the first of a K
//    block with scale-d = 0; the fragments alternate between two register
//    sets, since a stage's wgmmas read them until the next stage's wait.
//    At the end of a K block the warpgroup waits for its wgmmas and
//    promotes part into acc (64 + 64 f32 registers a thread), with the
//    scale reciprocals loaded one block ahead. Each slab lies in one
//    scale block (the route's condition), so ra and rb are one value each
//    a K block; a K block holds an even number of stages, so even stages
//    use one fragment set and odd stages the other.
//  - The epilogue casts and stores from registers.
// Limiter, seen on an H100 by ablation (copies of this source with a
// part taken out, timed against it in one run): not one part alone. The
// copies with B's conversion and the A fragments, without wgmmas, and
// the wgmmas with each K block's wait and promotion, without copies, each
// take most of the kernel's time; the promotion's two multiplies per
// element are a large share of the latter. The next steps are fewer bytes
// per tile (TMA multicast of a strip to the thread blocks of a cluster
// that share it) and a promotion that overlaps the next K block's wgmmas.
//
// cuda_core (fp8_gemm_launch; every other block with bk % 32 == 0). One
// thread block of 256 threads per 128 x 128 output tile, each thread an
// 8 x 8 register tile; the K loop walks the K blocks in 32-deep steps,
// decoding a 128 x 32 tile of A (stored k-major) and a 32 x 128 tile of
// B from fp8 bytes to f32 in shared memory, then an outer-product f32
// loop on CUDA cores; after each K block the promotion above, per
// element, so any bm, bn that divide M, N work.
//
// Both need N % 16 == 0, K % bk == 0 and 16-byte aligned operands (the
// wrapper checks).
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// cuda_core route
// ---------------------------------------------------------------------------
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

    // The K block's partial, scaled by its two block scales' reciprocals
    // in turn.
    float r_a[8], r_b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r_a[i] = rows[i] < M ? __frcp_rn(sa[(size_t)(rows[i] / bm) * nkb + kb]) : 1.0f;
      r_b[i] = cols[i] < N ? __frcp_rn(sb[(size_t)kb * nbn + cols[i] / bn]) : 1.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += (part[i][j] * r_a[i]) * r_b[j];
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

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------
#define W_BM 128       // output rows of a thread block: two MMA slabs of 64
#define W_BN 128       // output columns of a thread block
#define W_KS 64        // K of one stage
#define W_STAGES 6     // fp8 stages in the TMA ring
#define W_AHEAD 4      // stages the TMA runs ahead of the converter
#define W_HBUF 4       // f16 B buffers: one in flight, one issued, two converted ahead
#define W_THREADS 384  // converter warpgroup + two MMA warpgroups
#define W_FP8_A (W_BM * W_KS)               // A's fp8 bytes of a stage
#define W_FP8_STAGE (W_FP8_A + W_KS * W_BN)  // A's then B's
#define W_H_ATOM (W_KS * 128)                // B: one 64-column atom of 64 K rows
#define W_H_B (W_KS * W_BN * 2)              // B's f16 bytes of a buffer
#define W_SMEM (1024 + W_STAGES * W_FP8_STAGE + W_HBUF * W_H_B)

template <int FMT>
__device__ __forceinline__ uint32_t cvt_f16x2(uint32_t two_bytes) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two_bytes & 0xFFFFu),
                                                   FMT ? __NV_E5M2 : __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// 16 fp8 bytes -> 16 f16 values, exact: lo holds bytes 0..7, hi 8..15.
template <int FMT>
__device__ __forceinline__ void cvt16(const uint4 v, uint4& lo, uint4& hi) {
  lo = make_uint4(cvt_f16x2<FMT>(v.x), cvt_f16x2<FMT>(v.x >> 16), cvt_f16x2<FMT>(v.y),
                  cvt_f16x2<FMT>(v.y >> 16));
  hi = make_uint4(cvt_f16x2<FMT>(v.z), cvt_f16x2<FMT>(v.z >> 16), cvt_f16x2<FMT>(v.w),
                  cvt_f16x2<FMT>(v.w >> 16));
}

// Within one 16-deep wgmma the order of k is free if A and B share it.
// Lane (g, q) of a warp takes k = 16 q + 4 kk + j (j < 4) of a stage's 64
// at step kk: the m16n8k16 fragment's logical k = 2q + j (j < 2) and
// 2q + 8 + j - 2 (j >= 2). One 16-B load of each of its two A rows then
// feeds all four steps; B's stage row P lands in f16 row 16 kk + L with
// kk = (P / 4) % 4 and L the logical k of P.
__device__ __forceinline__ int w_b_row(int P) {
  const int jj = P & 3;
  return 16 * ((P >> 2) & 3) + 2 * (P >> 4) + (jj & 1) + 8 * (jj >> 1);
}

// Thread 0 of the converter: the TMA copies of stage t into its ring slot,
// once the slot's previous stage was read by all (the `empty` barrier).
__device__ __forceinline__ void w_load(const CUtensorMap* amap, const CUtensorMap* bmap,
                                       unsigned char* ring, uint64_t* full, uint64_t* empty,
                                       int t, int m0, int n0) {
  const int slot = t % W_STAGES;
  if (t >= W_STAGES) mbar_wait(&empty[slot], (uint32_t)(t / W_STAGES - 1) & 1u);
  // The stage's last readers (generic loads) before the TMA's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  unsigned char* st = ring + slot * W_FP8_STAGE;
  mbar_expect_tx(&full[slot], W_FP8_STAGE);
  tma_load_2d(st, amap, t * W_KS, m0, &full[slot]);
  tma_load_2d(st + W_FP8_A, bmap, n0, t * W_KS, &full[slot]);
}

// This thread's two A rows of stage s (16 B each: a quarter warp reads
// 128 contiguous bytes) into registers, once the stage has landed; then
// the warp frees the stage's A bytes.
__device__ __forceinline__ void w_load_a(const unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, int s, int r0, int lt, uint4& x,
                                         uint4& y) {
  const int slot = s % W_STAGES;
  mbar_wait(&full[slot], (uint32_t)(s / W_STAGES) & 1u);
  const unsigned char* fa = ring + slot * W_FP8_STAGE + 16 * (lt & 3);
  x = *reinterpret_cast<const uint4*>(fa + r0 * 64);
  y = *reinterpret_cast<const uint4*>(fa + (r0 + 8) * 64);
  __syncwarp();
  if ((lt & 31) == 0) mbar_arrive(&empty[slot]);
}

// One stage of an MMA warpgroup: A's bytes of stage s (x, y, read one
// stage earlier) converted into the four steps' register fragments `cur`
// (last read by stage s - 2's wgmmas, done); the four wgmmas of stage s
// (B from f16 buffer s % W_HBUF once converted; `first`: the K block's
// first stage, whose first wgmma overwrites `part`); the next stage's A
// bytes read while they run; and, once stage s - 1's wgmmas are done,
// the release of its f16 buffer. `prev`, stage s - 1's fragments, stays
// live until then.
template <int FA>
__device__ __forceinline__ void w_mma_stage(float (&part)[64], uint32_t (&cur)[4][4],
                                            uint32_t (&prev)[4][4], uint4& x, uint4& y,
                                            const unsigned char* ring, const unsigned char* hbuf,
                                            uint64_t* full, uint64_t* empty, uint64_t* hfull,
                                            uint64_t* hempty, int s, int nst, bool first, int r0,
                                            int lt) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    cur[kk][0] = cvt_f16x2<FA>(xs[kk]);
    cur[kk][1] = cvt_f16x2<FA>(ys[kk]);
    cur[kk][2] = cvt_f16x2<FA>(xs[kk] >> 16);
    cur[kk][3] = cvt_f16x2<FA>(ys[kk] >> 16);
  }
  const int hb = s % W_HBUF;
  mbar_wait(&hfull[hb], (uint32_t)(s / W_HBUF) & 1u);
  const uint32_t hb_addr = smem_u32(hbuf + hb * W_H_B);
  fence_regs(part);
  fence_regs(cur);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W_KS / 16; ++kk)
    wgmma_m64n128k16(part, cur[kk], w_desc(hb_addr + 16 * 128 * kk, W_H_ATOM, 1024),
                     (kk != 0) || !first);
  wgmma_commit();
  fence_regs(part);
  fence_regs(cur);
  if (s + 1 < nst) w_load_a(ring, full, empty, s + 1, r0, lt, x, y);
  wgmma_wait<1>();
  fence_regs(part);
  fence_regs(prev);
  if (s > 0) {
    __syncwarp();
    if ((lt & 31) == 0) mbar_arrive(&hempty[(s - 1) % W_HBUF]);
  }
}

template <int FA, int FB>
__global__ void __launch_bounds__(W_THREADS, 1)
fp8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap, const float* __restrict__ sa,
                      const float* __restrict__ sb, void* __restrict__ out, int M, int N, int K,
                      int bm, int bn, int bk, int out_f32) {
  extern __shared__ __align__(1024) unsigned char w_smem[];
  // full: a stage's TMA copies landed; empty: its fp8 bytes were read (4
  // converter warps, 8 MMA warps); hfull: its B converted (4 converter
  // warps); hempty: an f16 buffer's wgmmas are done (8 MMA warps).
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES];
  __shared__ __align__(8) uint64_t hfull[W_HBUF], hempty[W_HBUF];
  // The swizzle patterns repeat every 1024 B: align the buffers to it.
  unsigned char* ring = w_smem + ((1024 - (smem_u32(w_smem) & 1023)) & 1023);
  unsigned char* hbuf = ring + W_STAGES * W_FP8_STAGE;
  const int m0 = blockIdx.x * W_BM, n0 = blockIdx.y * W_BN;
  const int nst = K / W_KS;
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 12);
    }
    for (int i = 0; i < W_HBUF; ++i) {
      mbar_init(&hfull[i], 4);
      mbar_init(&hempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Converter: thread 0 keeps the TMA W_AHEAD stages ahead; the
    // warpgroup converts each landed stage's B (64 K rows, eight threads
    // a row, four rows a thread) into f16 buffer s % W_HBUF once its
    // wgmmas are done. Value n of stage row P lands in 64-column atom
    // n / 64, row w_b_row(P), chunk (n % 64) / 8, swizzled; the threads of
    // the second atom store their two chunks in the other order so that
    // a quarter warp's stores fall on distinct banks.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (lt == 0)
      for (int t = 0; t < W_AHEAD && t < nst; ++t)
        w_load(&amap, &bmap, ring, full, empty, t, m0, n0);
    for (int s = 0; s < nst; ++s) {
      if (lt == 0 && s + W_AHEAD < nst)
        w_load(&amap, &bmap, ring, full, empty, s + W_AHEAD, m0, n0);
      const int slot = s % W_STAGES, hb = s % W_HBUF;
      mbar_wait(&full[slot], (uint32_t)(s / W_STAGES) & 1u);
      if (s >= W_HBUF) mbar_wait(&hempty[hb], (uint32_t)(s / W_HBUF - 1) & 1u);
      const unsigned char* fb = ring + slot * W_FP8_STAGE + W_FP8_A;
      unsigned char* h = hbuf + hb * W_H_B;
#pragma unroll 2
      for (int i = 0; i < 4; ++i) {
        const int P = 16 * i + (lt >> 3), p = lt & 7, r = w_b_row(P);
        uint4 lo, hi;
        cvt16<FB>(*reinterpret_cast<const uint4*>(fb + P * 128 + 16 * p), lo, hi);
        unsigned char* row = h + (p >> 2) * W_H_ATOM + r * 128;
        const int c = (2 * p) & 7, sw = r & 7;
        const bool swap = p >= 4;
        *reinterpret_cast<uint4*>(row + (((swap ? c + 1 : c) ^ sw) << 4)) = swap ? hi : lo;
        *reinterpret_cast<uint4*>(row + (((swap ? c : c + 1) ^ sw) << 4)) = swap ? lo : hi;
      }
      // The f16 stores (generic proxy) before the wgmmas' reads (async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if ((lt & 31) == 0) {
        mbar_arrive(&hfull[hb]);
        mbar_arrive(&empty[slot]);
      }
    }
  } else {
    // MMA warpgroups: each owns a 64 x 128 slab of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int cw = wg - 1;
    const int spb = bk / W_KS, nkb = K / bk;
    // The slab's scale blocks: one row block, one column block.
    const float* sa_row = sa + (size_t)(min(m0 + 64 * cw, M - 1) / bm) * nkb;
    const float* sb_col = sb + n0 / bn;
    const int nbn = N / bn;
    const int r0 = 64 * cw + 16 * (lt >> 5) + ((lt & 31) >> 2);  // this thread's A rows: r0, r0 + 8
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
    uint32_t af0[4][4], af1[4][4];  // the A fragments of even and odd stages
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) af0[i][j] = af1[i][j] = 0u;
    float ra_next = __frcp_rn(__ldg(sa_row)), rb_next = __frcp_rn(__ldg(sb_col));
    uint4 x, y;  // this thread's A bytes of the next stage
    w_load_a(ring, full, empty, 0, r0, lt, x, y);
    // No branch touches `part` or the fragments: the compiler would
    // serialize the wgmmas. A K block holds an even number of stages
    // (the route's condition), so even stages use af0 and odd ones af1.
    for (int kb = 0; kb < nkb; ++kb) {
      const float ra = ra_next, rb = rb_next;
      if (kb + 1 < nkb) {
        ra_next = __frcp_rn(__ldg(sa_row + kb + 1));
        rb_next = __frcp_rn(__ldg(sb_col + (size_t)(kb + 1) * nbn));
      }
      for (int j = 0; j < spb; j += 2) {
        const int s = kb * spb + j;
        w_mma_stage<FA>(part, af0, af1, x, y, ring, hbuf, full, empty, hfull, hempty, s, nst,
                        j == 0, r0, lt);
        w_mma_stage<FA>(part, af1, af0, x, y, ring, hbuf, full, empty, hfull, hempty, s + 1,
                        nst, false, r0, lt);
      }
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += (part[i] * ra) * rb;
    }

    // Accumulator (i, e) of thread (warp w, lane g * 4 + q): row 16 w + g
    // + 8 (e >> 1), column 8 i + 2 q + (e & 1).
    const int w = lt >> 5, g = (lt & 31) >> 2, q = lt & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 8 * i + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * cw + 16 * w + g + 8 * hh;
        if (row >= M) continue;
        const float x = acc[4 * i + 2 * hh], y = acc[4 * i + 2 * hh + 1];
        const size_t o = (size_t)row * N + col;
        if (out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(x, y);
      }
    }
  }
}

template <int FA, int FB>
static cudaError_t w_launch(dim3 grid, cudaStream_t s, const CUtensorMap& amap,
                            const CUtensorMap& bmap, const float* sa, const float* sb, void* out,
                            int M, int N, int K, int bm, int bn, int bk, int out_f32) {
  static bool allowed = false;  // the >48 KB opt-in, once per instantiation
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(fp8_gemm_wgmma_kernel<FA, FB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               W_SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  fp8_gemm_wgmma_kernel<FA, FB><<<grid, W_THREADS, W_SMEM, s>>>(amap, bmap, sa, sb, out, M, N,
                                                                K, bm, bn, bk, out_f32);
  return cudaGetLastError();
}

// Dynamic shared memory of one wgmma-route thread block, in bytes.
extern "C" int fp8_gemm_wgmma_smem() { return W_SMEM; }

extern "C" int fp8_gemm_wgmma_launch(const void* a_q, const void* b_q, const void* a_scale,
                                     const void* b_scale, void* out, int M, int N, int K,
                                     int bm, int bn, int bk, int a_e5m2, int b_e5m2, int out_f32,
                                     void* stream) {
  if (M <= 0 || bm % 64 || bn % W_BN || bk % (2 * W_KS) || M % bm || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a_q | (uintptr_t)b_q) & 15) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  cudaError_t e = tma_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a_q, M, K, (size_t)K, W_KS,
                             W_BM, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return (int)e;
  e = tma_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, b_q, K, N, (size_t)N, W_BN, W_KS,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return (int)e;
  // Thread blocks ordered M fastest: those in flight share B's columns.
  const dim3 grid((unsigned)((M + W_BM - 1) / W_BM), (unsigned)(N / W_BN));
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sa = (const float*)a_scale;
  const float* sb = (const float*)b_scale;
  const int code = (a_e5m2 ? 2 : 0) | (b_e5m2 ? 1 : 0);
  if (code == 0) e = w_launch<0, 0>(grid, s, amap, bmap, sa, sb, out, M, N, K, bm, bn, bk, out_f32);
  else if (code == 1) e = w_launch<0, 1>(grid, s, amap, bmap, sa, sb, out, M, N, K, bm, bn, bk, out_f32);
  else if (code == 2) e = w_launch<1, 0>(grid, s, amap, bmap, sa, sb, out, M, N, K, bm, bn, bk, out_f32);
  else e = w_launch<1, 1>(grid, s, amap, bmap, sa, sb, out, M, N, K, bm, bn, bk, out_f32);
  return (int)e;
}
