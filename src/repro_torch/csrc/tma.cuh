// Hopper's Tensor Memory Accelerator (TMA) and the shared-memory
// barriers that its copies complete on, shared by the kernels that
// stream tiles through a ring of shared-memory stages (mixed_gemm's
// stream path, fp8_gemm's and flash_attention's wgmma routes): mbarrier
// init / arrive / expect / wait, 2-D and 3-D TMA loads, and a host-side
// cache of TMA descriptors.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)), "r"(count));
}

// One thread announces the bytes a TMA copy will bring to the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)), "r"(bytes));
}

// One arrival of the thread on the barrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=: mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"((uint32_t)__cvta_generic_to_shared(bar)),
      "r"(parity));
}

// A 2-D box of the tensor `map` at (x, y) into shared memory by the TMA.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(map), "r"(x), "r"(y), "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}

// A 3-D box of the tensor `map` at (x, y, z) into shared memory by the TMA.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// A TMA descriptor of a tensor of `type` values of `rank` (2 or 3)
// dimensions, dims[0] contiguous, dims[i] strides[i - 1] bytes apart,
// read in boxes of box[0] x box[1] (x box[2]); coordinates past a
// dimension's extent read as zeros. cuTensorMapEncodeTiled is found once
// through the runtime (no link to libcuda). Encoding takes the host tens
// of microseconds, so the last TMA_MAPS descriptors are kept, keyed by
// everything they encode: a weight's is reused by every call, an
// activation's whenever the allocator hands its buffer out again. Each
// library that includes this header keeps its own cache.
#define TMA_MAPS 64
struct TmaMapKey {
  const void* p;
  int type, rank, swizzle;
  size_t dims[3], strides[2];
  int box[3];
};

static cudaError_t tma_map(CUtensorMap* map, CUtensorMapDataType type, const void* p, int rank,
                           const size_t* dims, const size_t* strides, const int* box,
                           CUtensorMapSwizzle swizzle) {
  static std::mutex lock;
  static TensorMapEncodeTiled encode = nullptr;
  static TmaMapKey keys[TMA_MAPS];
  static CUtensorMap maps[TMA_MAPS];
  static int used = 0, next = 0;
  TmaMapKey key;
  memset(&key, 0, sizeof(key));  // padding too: keys compare with memcmp
  key.p = p;
  key.type = (int)type;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return cudaSuccess;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (fn == nullptr || found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = (TensorMapEncodeTiled)fn;
  }
  cuuint64_t gdims[3], gstrides[2];
  cuuint32_t gbox[3], step[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdims[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    if (i > 0) gstrides[i - 1] = (cuuint64_t)strides[i - 1];
  }
  const CUresult r = encode(map, type, (cuuint32_t)rank, const_cast<void*>(p), gdims, gstrides,
                            gbox, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % TMA_MAPS;
  if (used < TMA_MAPS) ++used;
  return cudaSuccess;
}

// A row-major (rows, cols) matrix with rows `pitch` bytes apart, read in
// boxes of box_cols x box_rows; rows past `rows` read as zeros.
static cudaError_t tma_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                              int rows, int cols, size_t pitch, int box_cols, int box_rows,
                              CUtensorMapSwizzle swizzle) {
  const size_t dims[2] = {(size_t)cols, (size_t)rows}, strides[1] = {pitch};
  const int box[2] = {box_cols, box_rows};
  return tma_map(map, type, p, 2, dims, strides, box, swizzle);
}

// A batch of `mats` row-major (rows, cols) matrices, rows `pitch` bytes
// apart and matrices `mat_pitch` bytes apart, read in boxes of box_cols x
// box_rows of one matrix: rows past `rows` read as zeros, never as the
// next matrix's first rows.
static cudaError_t tma_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                              int mats, int rows, int cols, size_t pitch, size_t mat_pitch,
                              int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const size_t dims[3] = {(size_t)cols, (size_t)rows, (size_t)mats};
  const size_t strides[2] = {pitch, mat_pitch};
  const int box[3] = {box_cols, box_rows, 1};
  return tma_map(map, type, p, 3, dims, strides, box, swizzle);
}
