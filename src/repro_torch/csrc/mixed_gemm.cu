// mixed_gemm: the mixed-representation block GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mixed_gemm.py:214
// mixed_gemm_blocks: C = A @ B^T over two MixedOperands, every (br, bk)
// block decoded per its tag (E4M3 / E5M2 / BF16 / NVFP4) to its stored
// bf16 value -- bf16(fp8 / scale), the BF16 passthrough, or
// bf16(f32(e2m1 * micro) / scale) -- and accumulated in f32, cast once
// to the output dtype. A lane is read only where a tag names it, so
// compact lanes are never touched. Two paths, chosen by the wrapper from
// M alone (kernels/mixed_gemm.py:gemm_path):
//
// stream (mixed_gemm_launch; M <= 64: decode, prefill chunks, the f32
// head). Bound on an H100: bytes. Serving GEMMs have a handful of
// activation rows, so the weight's payload (~1 B/element for fp8
// blocks) is the traffic, and the work per byte is far below the roof.
// Design (mixed_gemm_stream_kernel): each 256-thread block owns 128
// weight rows (16 per warp) and a range of K in 64-deep chunks, streamed
// through a ring of 3 stages filled by the TMA (one 64 B x 128-row box
// of fp8 bytes and one 64 x 8 NT box of the activation's bf16 a chunk,
// on one mbarrier a stage): each weight byte is read once, the next
// chunk is in flight while one is multiplied, and one barrier a chunk
// frees a stage; the TMA moves a whole box per instruction, where 16-B
// copies by every thread of 64 B a row kept the load units busy and fell
// short of the card's rate. An fp8 block's stored value is a
// function of (byte, format, scale) alone, so the block's 256-entry bf16
// table, round_bf16(fp8 / scale) with decode()'s IEEE division (256
// divisions per 128 x 128 block), is built in shared memory, one copy per
// lane in the lane's own bank (32 KB), and the fragments are looked up in
// it: one shift, one LOP3 and one conflict-free load per element. BF16
// blocks are read directly; NVFP4 blocks, and packs whose blocks do not
// tile the thread block (row block not a multiple of 128, K block not of
// 64), are decoded element by element with decode(). The activation is
// read from its own bf16 lane where its lanes say every tag is BF16 (fp8
// and NVFP4 lanes compact, bf16 lane dense: the serving passthrough
// pack), else its stored values are decoded once per launch into the
// workspace. The products run on the tensor cores with the roles
// swapped: mma.sync m16n8k16 with 16 weight rows as its rows and up to 8
// n-tiles of tokens as its columns (M = 4 pads one n-tile, which costs
// nothing against the bytes). A bf16 x bf16 product is exact in f32; each
// 64-deep partial joins the f32 total by an IEEE add. Where the row
// strips cannot fill the card, the wrapper's plan splits K over blocks
// into f32 partials, and the last block of each strip to finish (an
// integer ticket) sums them in split order, so results repeat bit for bit.
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
#include "tma.cuh"

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

// Stored value of element (row, k) of a block with metadata m (the plain
// version's decode, element by element).
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

__device__ __forceinline__ float decode_at(const Operand& P, int row, int k, int Kp, int bk,
                                           int nk, const float* lut) {
  if (k >= Kp) return 0.0f;
  return decode(P, row_meta(P, row, k / bk, nk), row, k, Kp, lut);
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(f2bf(v));
}

// ---------------------------------------------------------------------------
// stream path: the weight streamed once through a TMA-filled ring, decoded
// through per-block tables into mma.sync fragments (weight rows as the
// MMA's 16 rows, tokens as its 8 columns).
// ---------------------------------------------------------------------------
#define ST_ROWS 128     // weight rows per thread block: 8 warps x 16
#define ST_KC 64        // K of one pipeline stage
#define ST_STAGES 3     // chunks in the ring: two in flight while one is multiplied
#define ST_THREADS 256
#define ST_GROUP 1024   // bytes of one warp's 16 fp8 rows in a stage (64 B a row)
#define ST_TABLE 32768  // the fp8 table: 256 words (a bf16 entry each) for each of 32 lanes
#define ST_MAX_SMEM (232448 - 1024)  // the card's 227 KB less room for static barriers

// Bytes of one stage: the activation's rows (first: 128-B swizzled boxes
// start on 1024 B) and the weight's fp8 rows, rounded up to 1024.
__host__ __device__ constexpr int ST_A_BYTES(int nt) { return (8 * nt * 128 + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int st_stage_bytes(int nt) {
  return ST_A_BYTES(nt) + ST_ROWS / 16 * ST_GROUP;
}

// Whether a weight block with this tag is streamed as fp8 bytes and
// looked up in the table (E4M3, E5M2, and NVFP4 where the pack has no
// NVFP4 lanes, which the plain version decodes as E4M3).
__device__ __forceinline__ bool st_fp8(int tag, const Operand& B) {
  return tag != TAG_BF16 && !(tag == TAG_NVFP4 && B.nv) && B.q_dense;
}

// The stage of chunk c (k in [64c, 64c + 64)), issued by thread 0 as TMA
// copies that complete on `bar`: the activation's 8 NT x 64 bf16 box
// (bf16 with row stride Kd: its own bf16 lane, or its values decoded once
// per launch; rows past it read as zeros), 128-B rows swizzled by the
// TMA (16-B piece p of row r at p ^ (r & 7)) so that the fragments' loads
// spread over the banks; and, in FAST mode, where one row block holds
// all 128 rows and `tag` is the thread block's fp8 tag, the weight's
// bytes as one 64 B x 128 box (rows at stride 64 B; rows past the pack
// read as zeros).
template <int NT, bool FAST>
__device__ __forceinline__ void st_stage(const Operand& B, const CUtensorMap* wmap,
                                         const CUtensorMap* amap, int tag, unsigned char* sb,
                                         uint64_t* bar, int c, int R0) {
  if (threadIdx.x != 0) return;
  const bool w = FAST && st_fp8(tag, B);
  // The buffer's last readers (generic loads) are done: order them
  // before the async proxy's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, 8 * NT * 128 + (w ? ST_ROWS / 16 * ST_GROUP : 0));
  tma_load_2d(sb, amap, c * ST_KC, 0, bar);
  if (w) tma_load_2d(sb + ST_A_BYTES(NT), wmap, c * ST_KC, R0, bar);
}

// The fp8 table of a block: entry e = round_bf16(fp8(e) / scale), with
// decode()'s IEEE division, kept once for each lane (word e * 32 + lane)
// so that a warp's 32 lookups never share a bank. Thread tid computes
// entry tid and writes its 32 copies in 16-B stores, a quarter warp's
// eight stores on distinct banks.
__device__ __forceinline__ void st_build_table(uint32_t* tab, const float* lut, int tag,
                                               float scale) {
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t v = bf16_bits(lut[(tag == TAG_E5M2 ? 256 : 0) + tid] / scale);
  uint4* row = reinterpret_cast<uint4*>(tab + tid * 32);
#pragma unroll
  for (int i = 0; i < 8; ++i) row[(lane + i) & 7] = make_uint4(v, v, v, v);
}

// The table entries of the four bytes of `word` for this lane (`lane4`
// = 4 x lane, its byte offset in every table row), packed as two bf16
// pairs: one shift and one LOP3 form each lookup's address.
__device__ __forceinline__ void st_lookup(const unsigned char* tab, uint32_t lane4,
                                          uint32_t word, uint32_t& lo, uint32_t& hi) {
  const uint32_t v0 = *reinterpret_cast<const uint32_t*>(tab + (((word << 7) & 0x7F80u) | lane4));
  const uint32_t v1 = *reinterpret_cast<const uint32_t*>(tab + (((word >> 1) & 0x7F80u) | lane4));
  const uint32_t v2 = *reinterpret_cast<const uint32_t*>(tab + (((word >> 9) & 0x7F80u) | lane4));
  const uint32_t v3 = *reinterpret_cast<const uint32_t*>(tab + (((word >> 17) & 0x7F80u) | lane4));
  lo = __byte_perm(v0, v1, 0x5410);
  hi = __byte_perm(v2, v3, 0x5410);
}

// Two k-pairs (16 x 2 B) of the bf16 values of weight row `row`, k in
// [k, k + 16): a BF16 block's lane read directly, or (NVFP4 blocks, a
// missing lane, !FAST) each element decoded with decode(). Rows beyond
// N are zero. Off the fp8 path, these chunks skip the ring.
template <bool FAST>
__device__ __forceinline__ void st_row_bf16(const Operand& B, int tag, int row, int k, int Kp,
                                            int bk, int nk, const float* lut, uint32_t (&v)[8]) {
  if (row >= B.rows) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0u;
  } else if (FAST && tag == TAG_BF16 && B.bf_dense) {
    const uint4* p = reinterpret_cast<const uint4*>(B.bf + (size_t)row * Kp + k);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = bf16_bits(decode_at(B, row, k + 2 * i, Kp, bk, nk, lut)) |
             ((uint32_t)bf16_bits(decode_at(B, row, k + 2 * i + 1, Kp, bk, nk, lut)) << 16);
  }
}

// C = A @ B^T for M <= 8 NT rows of A (bf16 in the tensor of `amap`, Kd
// columns): thread block (blockIdx.x, blockIdx.y) computes
// weight rows [128 x, 128 x + 128) over the chunks of split y. Within one
// m16n8k16 MMA the order of k is free if both operands share it, so lane
// (g, t) of a warp takes k = 16t + 4s + j (j < 4) of the stage's 64 at
// k-step s: 16 bytes of each of its two weight rows (g, g + 8) feed all
// four k-steps, and one 16-B load of a token row feeds two.
template <int NT, bool FAST>
__global__ void __launch_bounds__(ST_THREADS)
mixed_gemm_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap amap, int Kd, int M, Operand B,
                         void* __restrict__ out, float* __restrict__ partial,
                         int* __restrict__ tickets, int out_f32, int Kp, int bk, int nk,
                         int splits, int meta_n, int cps) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  __shared__ __align__(8) uint64_t bars[ST_STAGES];  // a stage's TMA copy has landed
  unsigned char* tab = st_smem;  // FAST only
  float* lut = reinterpret_cast<float*>(st_smem + (FAST ? ST_TABLE : 0));  // E4M3, then E5M2
  // FAST: the tags and scales of the row block's K blocks that this split
  // reads, loaded once so that no stage waits on a global load.
  int* mtag = reinterpret_cast<int*>(lut + 512);
  float* mscale = reinterpret_cast<float*>(mtag + meta_n);
  int* cmeta = reinterpret_cast<int*>(mscale + meta_n);  // chunk c0 + i: its K block - kb0
  unsigned char* ring = reinterpret_cast<unsigned char*>(cmeta + cps);
  ring += (1024 - ((uintptr_t)ring & 1023)) & 1023;
  constexpr int SB = st_stage_bytes(NT);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int R0 = blockIdx.x * ST_ROWS, z = blockIdx.y;
  const int nch = Kd / ST_KC;
  const int c0 = (int)((long long)nch * z / splits), c1 = (int)((long long)nch * (z + 1) / splits);
  const int rb = R0 / B.br, kb0 = c0 * ST_KC / bk;
  for (int b = tid; b < 256; b += ST_THREADS) {
    lut[b] = fp8_to_float((uint8_t)b, __NV_E4M3);
    lut[256 + b] = fp8_to_float((uint8_t)b, __NV_E5M2);
  }
  for (int i = tid; i < meta_n; i += ST_THREADS) {
    const bool in = kb0 + i < nk;
    mtag[i] = in ? B.tags[rb * nk + kb0 + i] : TAG_BF16;
    mscale[i] = in ? B.scales[rb * nk + kb0 + i] : 1.0f;
  }
  if (FAST)
    for (int i = tid; i < c1 - c0; i += ST_THREADS) cmeta[i] = (c0 + i) * ST_KC / bk - kb0;
  if (tid == 0) {
    for (int i = 0; i < ST_STAGES; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto tag_of = [&](int c) { return FAST ? mtag[cmeta[c - c0]] : TAG_BF16; };

  float acc[NT][4], part[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < ST_STAGES - 1; ++i) {
    if (c0 + i < c1)
      st_stage<NT, FAST>(B, &wmap, &amap, tag_of(c0 + i), ring + i * SB, &bars[i], c0 + i, R0);
  }
  uint32_t phase = 0;  // bit s: the parity of stage s's next TMA completion
  int tab_kb = -1;  // the K block (- kb0) whose table `tab` holds
  const uint32_t lane4 = 4u * lane;
  for (int c = c0; c < c1; ++c) {
    const int tag = tag_of(c);
    const bool fp8 = FAST && st_fp8(tag, B);
    const int sc = (c - c0) % ST_STAGES;
    mbar_wait(&bars[sc], (phase >> sc) & 1);
    phase ^= 1u << sc;
    __syncthreads();  // chunk c has landed; chunk c - 1 (and its table) is done with
    const int n = c + ST_STAGES - 1;
    if (n < c1) {
      const int sn = (n - c0) % ST_STAGES;
      st_stage<NT, FAST>(B, &wmap, &amap, tag_of(n), ring + sn * SB, &bars[sn], n, R0);
    }
    if (fp8 && cmeta[c - c0] != tab_kb) {  // uniform across the thread block
      tab_kb = cmeta[c - c0];
      st_build_table(reinterpret_cast<uint32_t*>(tab), lut, tag, mscale[tab_kb]);
      __syncthreads();
    }
    const int rg = R0 + 16 * w;
    if (rg >= B.rows) continue;

    const unsigned char* sb = ring + sc * SB;
    const unsigned char* As = sb;
    // af[s]: the A fragment of k-step s (rows g, g + 8; k 16t + 4s + {0,1}
    // then {2,3}).
    uint32_t af[4][4];
    if (fp8) {
      const unsigned char* grp = sb + ST_A_BYTES(NT) + w * ST_GROUP;
      const uint4 x = *reinterpret_cast<const uint4*>(grp + 64 * g + 16 * t);
      const uint4 y = *reinterpret_cast<const uint4*>(grp + 64 * (g + 8) + 16 * t);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        st_lookup(tab, lane4, xs[s], af[s][0], af[s][2]);
        st_lookup(tab, lane4, ys[s], af[s][1], af[s][3]);
      }
    } else {
      uint32_t x[8], y[8];
      st_row_bf16<FAST>(B, tag, rg + g, c * ST_KC + 16 * t, Kp, bk, nk, lut, x);
      st_row_bf16<FAST>(B, tag, rg + g + 8, c * ST_KC + 16 * t, Kp, bk, nk, lut, y);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        af[s][0] = x[2 * s]; af[s][2] = x[2 * s + 1];
        af[s][1] = y[2 * s]; af[s][3] = y[2 * s + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // Token row 8j + g, k 16t + 8h + [0, 8) (k-steps 2h, 2h + 1): the
        // row's 16-B piece 2t + h, swizzled by the row (g).
        const uint4 b =
            *reinterpret_cast<const uint4*>(As + (8 * j + g) * 128 + (((2 * t + h) ^ g) << 4));
        mma_bf16(part[j], af[2 * h], b.x, b.y);
        mma_bf16(part[j], af[2 * h + 1], b.z, b.w);
      }
    // The tensor cores' f32 accumulation does not round to nearest at
    // every add: each 64-deep partial joins the total by an IEEE add.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += part[j][e];
        part[j][e] = 0.0f;
      }
  }

  const int N = B.rows;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = R0 + 16 * w + g + (e >> 1) * 8, tok = 8 * j + 2 * t + (e & 1);
      if (row >= N || tok >= M) continue;
      const size_t o = (size_t)tok * N + row;
      if (splits > 1) partial[(size_t)z * M * N + o] = acc[j][e];
      else if (out_f32) ((float*)out)[o] = acc[j][e];
      else ((__nv_bfloat16*)out)[o] = f2bf(acc[j][e]);
    }
  if (splits == 1) return;
  // The strip's last thread block to finish (an integer ticket; the
  // order of arrival does not touch the sum) adds the splits' partials
  // in split order and casts once, so a result never depends on timing.
  __shared__ int last;
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = (size_t)M * N;
  for (int e = tid; e < M * ST_ROWS; e += ST_THREADS) {
    const int tok = e / ST_ROWS, row = R0 + e % ST_ROWS;
    if (row >= N) continue;
    const size_t o = (size_t)tok * N + row;
    float v = 0.0f;
    for (int zz = 0; zz < splits; ++zz) v += __ldcg(partial + zz * mn + o);
    if (out_f32) ((float*)out)[o] = v;
    else ((__nv_bfloat16*)out)[o] = f2bf(v);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;  // ready for the next launch
}

static bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p & (n - 1)) == 0; }

template <int NT, bool FAST>
static cudaError_t st_allow_smem() {
  return cudaFuncSetAttribute(mixed_gemm_stream_kernel<NT, FAST>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, ST_MAX_SMEM);
}

template <int NT>
static void st_launch(bool fast, dim3 grid, size_t smem, cudaStream_t s, const CUtensorMap& wmap,
                      const CUtensorMap& amap, int Kd, int M, const Operand& B, void* out,
                      float* part, int* tickets, int out_f32, int Kp, int bk, int nk,
                      int splits, int meta_n, int cps) {
  if (fast)
    mixed_gemm_stream_kernel<NT, true><<<grid, ST_THREADS, smem, s>>>(
        wmap, amap, Kd, M, B, out, part, tickets, out_f32, Kp, bk, nk, splits, meta_n, cps);
  else
    mixed_gemm_stream_kernel<NT, false><<<grid, ST_THREADS, smem, s>>>(
        wmap, amap, Kd, M, B, out, part, tickets, out_f32, Kp, bk, nk, splits, meta_n, cps);
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

static cudaError_t tc_decode_launch(const Operand& P, __nv_bfloat16* out, int Rd, int Kd, int Kp,
                                    int bk, cudaStream_t s) {
  // One load per 8 elements where the 8 share a pack block and every
  // lane the tags may name is aligned for it.
  const int vec = bk % 8 == 0 && Kp % 8 == 0 && (!P.q_dense || aligned(P.q, 16)) &&
                  (!P.bf_dense || aligned(P.bf, 16)) && (!P.nv || aligned(P.nib, 16));
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

// ---------------------------------------------------------------------------
// stream path launch
// ---------------------------------------------------------------------------
// Lets every stream kernel take up to the card's shared memory (above the
// 48 KB default); once per process and device, before the first launch.
extern "C" int mixed_gemm_stream_setup() {
  cudaError_t err = st_allow_smem<1, true>();
  if (err == cudaSuccess) err = st_allow_smem<2, true>();
  if (err == cudaSuccess) err = st_allow_smem<4, true>();
  if (err == cudaSuccess) err = st_allow_smem<8, true>();
  if (err == cudaSuccess) err = st_allow_smem<1, false>();
  if (err == cudaSuccess) err = st_allow_smem<2, false>();
  if (err == cudaSuccess) err = st_allow_smem<4, false>();
  if (err == cudaSuccess) err = st_allow_smem<8, false>();
  return (int)err;
}

// The stream path, M <= 64: one streaming kernel, after a small one that
// decodes the activation's stored values into the head of `workspace`
// (8 NT rows of Kp rounded up to 64, bf16) unless A's lanes say every
// tag is BF16 (a lane is compact only where no tag names it), when its
// bf16 lane is read as it is. Where `splits`
// (kernels/mixed_gemm.py:stream_plan) cuts K into that many ranges of
// 64-deep chunks, splits x M x N f32 partials follow in `workspace`, and
// `tickets` (one int per 128-row strip, zero between launches) tells each
// strip's last thread block to sum them. A `workspace_floats` short of
// that layout is refused.
extern "C" int mixed_gemm_launch(
    const void* a_q, const void* a_bf, const void* a_nib, const void* a_ms, const void* a_tags,
    const void* a_scales, int a_br, int M, int a_q_dense, int a_bf_dense, int a_nv,
    const void* b_q, const void* b_bf, const void* b_nib, const void* b_ms, const void* b_tags,
    const void* b_scales, int b_br, int N, int b_q_dense, int b_bf_dense, int b_nv,
    void* out, void* workspace, long long workspace_floats, void* tickets, int splits,
    int out_f32, int Kp, int bk, void* stream) {
  Operand A{(const uint8_t*)a_q, (const __nv_bfloat16*)a_bf, (const uint8_t*)a_nib,
            (const uint8_t*)a_ms, (const int32_t*)a_tags, (const float*)a_scales,
            a_br, M, a_q_dense, a_bf_dense, a_nv};
  Operand B{(const uint8_t*)b_q, (const __nv_bfloat16*)b_bf, (const uint8_t*)b_nib,
            (const uint8_t*)b_ms, (const int32_t*)b_tags, (const float*)b_scales,
            b_br, N, b_q_dense, b_bf_dense, b_nv};
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (M > 64 || splits < 1 || workspace == nullptr || (splits > 1 && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nt = M <= 8 ? 1 : (M <= 16 ? 2 : (M <= 32 ? 4 : 8));
  const int Kd = (Kp + ST_KC - 1) / ST_KC * ST_KC, nk = Kp / bk;
  const long long act_floats = (long long)8 * nt * Kd / 2;
  if (workspace_floats < act_floats + (splits > 1 ? (long long)splits * M * N : 0))
    return (int)cudaErrorInvalidValue;
  float* part = (float*)workspace + act_floats;
  // Tables and copies need the 128 rows of a thread block in one row
  // block, each stage in one K block and 16-B aligned weight lanes; other
  // packs decode element by element in the same kernel.
  const bool fast = B.br % ST_ROWS == 0 && bk % ST_KC == 0 && (!B.q_dense || aligned(B.q, 16)) &&
                    (!B.bf_dense || aligned(B.bf, 16));
  // The K blocks of the longest split (its chunks may start inside one).
  const int cps = (Kd / ST_KC + splits - 1) / splits;
  const int meta_n = fast ? cps * ST_KC / bk + 1 : 0;
  const size_t smem = (fast ? ST_TABLE : 0) + 512 * 4 + (size_t)8 * meta_n + (size_t)4 * cps +
                      1024 + (size_t)ST_STAGES * st_stage_bytes(nt);
  if (smem > ST_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // The weight's fp8 lane in 64 B x 128-row boxes (FAST); the activation
  // in 64 x 8 NT bf16 boxes, from its own lane where every tag is BF16,
  // else from its stored values decoded into `workspace`.
  CUtensorMap wmap, amap;
  memset(&wmap, 0, sizeof(wmap));
  if (fast && B.q_dense) {
    const cudaError_t e = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, B.q,
                                     (N + B.br - 1) / B.br * B.br, Kp, Kp, ST_KC, ST_ROWS,
                                     CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t err;
  if (!A.q_dense && !A.nv && A.bf_dense && Kp == Kd && aligned(A.bf, 16)) {
    err = tma_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A.bf,
                     (M + A.br - 1) / A.br * A.br, Kp, (size_t)Kp * 2, ST_KC, 8 * nt,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    err = tc_decode_launch(A, (__nv_bfloat16*)workspace, 8 * nt, Kd, Kp, bk, s);
    if (err == cudaSuccess)
      err = tma_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, workspace, 8 * nt, Kd,
                       (size_t)Kd * 2, ST_KC, 8 * nt, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + ST_ROWS - 1) / ST_ROWS), (unsigned)splits);
  int* tk = (int*)tickets;
  if (nt == 1)
    st_launch<1>(fast, grid, smem, s, wmap, amap, Kd, M, B, out, part, tk, out_f32, Kp, bk,
                 nk, splits, meta_n, cps);
  else if (nt == 2)
    st_launch<2>(fast, grid, smem, s, wmap, amap, Kd, M, B, out, part, tk, out_f32, Kp, bk,
                 nk, splits, meta_n, cps);
  else if (nt == 4)
    st_launch<4>(fast, grid, smem, s, wmap, amap, Kd, M, B, out, part, tk, out_f32, Kp, bk,
                 nk, splits, meta_n, cps);
  else
    st_launch<8>(fast, grid, smem, s, wmap, amap, Kd, M, B, out, part, tk, out_f32, Kp, bk,
                 nk, splits, meta_n, cps);
  return (int)cudaGetLastError();
}
