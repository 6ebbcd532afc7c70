// PTX wrappers shared by the port's Hopper (sm_90a) kernels: cp.async with
// zero-fill, wgmma's fence/commit/wait, mbarriers with a bounded wait, TMA
// 2-D loads, the 128-byte-swizzle shared-memory descriptor, bulk stores, and
// on the host a cache of 2-D tensor maps.  Included by int8_conv.cu and
// inception_blocks.cu, each compiled into its own library.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int G>  // 16 or 4 bytes; src-size 0 zero-fills the destination
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_size) {
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_size));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes the generic-proxy writes (cp.async, st.shared) visible to wgmma's
// async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// mbarrier and TMA (the weight tile).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity.  A transfer that never
// completes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// A 2-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
// Advancing K by 32 bytes adds 2 to the address field.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gdst),
               "r"(smem_u32(ssrc)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <bool READ_ONLY>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ_ONLY)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The tensor map of a [rows][K] row-major weight matrix of `dtype`
// (`elem` bytes) in boxes of [box_rows][box_k], in the 128-byte swizzle,
// out-of-range elements read as zero.  Encoded by cuTensorMapEncodeTiled,
// looked up at run time (the build links only the runtime), once per
// weight tensor and box: a hash table of 1024 maps, so an engine's every
// conv site keeps its map (a miss re-encodes, several microseconds of host
// time).
int weight_map(const void* w, CUtensorMapDataType dtype, int elem, int K, int rows, int box_k,
               int box_rows, CUtensorMap* out) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  struct Entry {
    const void* w;
    int K, rows, box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 1024, PROBES = 8;
  static Entry table[SLOTS];
  const uint64_t h = ((uint64_t)(uintptr_t)w >> 8) * 0x9E3779B97F4A7C15ull ^
                     ((uint64_t)K << 32 | (uint64_t)rows << 8 | (uint64_t)box_rows);
  Entry* slot = nullptr;
  for (int i = 0; i < PROBES; ++i) {
    Entry& e = table[(h + i) & (SLOTS - 1)];
    if (e.w == w && e.K == K && e.rows == rows && e.box_rows == box_rows) {
      *out = e.map;
      return (int)cudaSuccess;
    }
    if (!slot && !e.w) slot = &e;
  }
  if (!slot) slot = &table[h & (SLOTS - 1)];   // a full run: replace its first entry
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&slot->map, dtype, 2, const_cast<void*>(w), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    slot->w = nullptr;
    return (int)cudaErrorInvalidValue;
  }
  slot->w = w;
  slot->K = K;
  slot->rows = rows;
  slot->box_rows = box_rows;
  *out = slot->map;
  return (int)cudaSuccess;
}

}  // namespace
