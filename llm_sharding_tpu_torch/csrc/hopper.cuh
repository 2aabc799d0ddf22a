// Hopper (sm_90a) building blocks of the tensor-core kernels
// (flash_attention.cu, paged_prefill.cu, paged_attention.cu): mbarriers,
// TMA tile loads, the proxy fence, wgmma shared-memory descriptors for
// 128-byte-swizzled bf16 tiles, the wgmma shapes the kernels issue, the
// mma.sync / ldmatrix fragments of the decode kernel, cp.async and the
// TF32 split products of flash's f32 route, and the host-side tensor-map
// encoders.
//
// The tensor-map encoder (cuTensorMapEncodeTiled) lives in libcuda, not in
// the runtime. It is looked up in the already-loaded libcuda with dlsym, so the
// kernel libraries link against nothing but the CUDA runtime and libdl.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spin until the barrier's phase of the given parity has completed. A
// protocol fault traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --------------------------------------------------------------------- TMA
// One 4-D box of the tensor map into shared memory; completion is counted
// in bytes on the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// cp.async of 16 bytes (or `bytes` < 16, the rest zero-filled; 0 reads
// nothing) from global to shared memory, completed by cp_async_wait.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// cp.async of one 4-byte word (0 bytes: zero-filled, nothing read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's plain shared-memory stores before later reads of
// the same bytes by the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout type
// B128): start address, leading and stride byte offsets, in 16-byte units.
// The tile's 1024-byte swizzle atoms must be 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
#define HOPPER_D32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),              \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),           \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),           \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory, bf16 in, f32 accumulate; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16x2 per
// thread, the m64k16 fragment), B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define HOPPER_D64(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] += A[64 x 16] . B[16 x 128], as above with two 64-column
// B atoms lbo bytes apart.
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------ mma.sync, ldmatrix
// Four 8 x 8 b16 matrices from shared memory (lanes 8i..8i+7 give the row
// addresses of matrix i); .trans hands each thread the transposed element.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate (the
// m16n8k16 fragments: a row-major, b column-major).
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (round to nearest, ties away), as an f32 bit pattern
// whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x as the TF32 pair (big, small) with x ~= big + small to ~2^-22
// relative: the operands of a 3xTF32 product.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// d[16 x 8] += a[16 x 8] . b[8 x 8], TF32 in, f32 accumulate (the m16n8k8
// fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8,
// 2t), d3 (g + 8, 2t + 1); g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_1688_tf32(float* d, const uint32_t* a, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A dense tensor [d3][d2][d1][d0] of `esize`-byte elements read in boxes of
// box0 x box1 x box_rows x 1 elements, landing in shared memory as
// box1 * box_rows consecutive rows of box0 elements (dim 1 fastest); boxes
// past the end of dims 1 and 2 are zero-filled. Returns false if libcuda
// refuses.
inline bool map_4d(CUtensorMap* map, const void* base, CUtensorMapDataType dt, uint64_t esize,
                   uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3, uint32_t box0,
                   uint32_t box_rows, CUtensorMapSwizzle swizzle, uint32_t box1 = 1) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * esize, d0 * d1 * esize, d0 * d1 * d2 * esize};
  const cuuint32_t box[4] = {box0, box1, box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, dt, 4, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor [d3][d2][d1][d0] (d0 contiguous, dense) read in boxes of
// 64 x box1 x box_rows x 1 elements, 128-byte swizzled: box1 * box_rows rows
// of 128 bytes, as a 64-row wgmma tile's rows (at most 64 of them; a box of
// fewer than 64 rows lands at a 1024-byte-aligned row offset of a tile with
// the tile's swizzle when box_rows is a multiple of 8).
inline bool map_bf16_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                        uint64_t d2, uint64_t d3, uint32_t box_rows = 64, uint32_t box1 = 1) {
  return map_4d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, d0, d1, d2, d3, 64, box_rows,
                CU_TENSOR_MAP_SWIZZLE_128B, box1);
}

// An f32 tensor read like map_bf16_4d: 32-column (128-byte) boxes,
// 128-byte swizzled.
inline bool map_f32_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                       uint64_t d2, uint64_t d3, uint32_t box_rows) {
  return map_4d(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, d0, d1, d2, d3, 32, box_rows,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// A 1-byte tensor [d3][d2][d1][d0] (int8 / fp8 codes, d0 contiguous, dense;
// d0 a multiple of 16, at most 256) read in unswizzled boxes of
// d0 x 1 x box_rows x 1 bytes: rows of d0 bytes, one after another.
inline bool map_u8_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                      uint64_t d3, uint32_t box_rows) {
  return map_4d(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, d0, d1, d2, d3,
                static_cast<uint32_t>(d0), box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
