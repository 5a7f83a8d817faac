// Hopper (sm_90a) primitives of the tensor-core flash kernels
// (flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu, bf16 paths), in
// inline PTX: mbarriers with phase parity, TMA tiled loads and stores
// (cp.async.bulk.tensor), the wgmma shared-memory descriptor for the
// 128-byte swizzle, and wgmma.mma_async m64nNk16 bf16 -> fp32 with A from
// shared memory or from registers. The host half encodes TMA tensor maps
// with cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint, so the libraries need no -lcuda.
//
// Shared-memory tiles. Every bf16 tile is stored as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B and an inner box of 64 values (128 bytes):
// for each 64-column slice of the head dim ("half"), rows of 128 bytes
// one after another, the 16-byte chunk c of row r at chunk c ^ (r % 8).
// A D=128 tile is two such slices, [D / 64][rows][64]. Slices start on
// 1024-byte boundaries, so the swizzle's phase is the row's own.
//
// wgmma reads such a tile in one of two ways (desc_kmajor, desc_mnmajor):
// K-major, when the product's depth runs along the stored row (the head
// dim of Q and K in Q.K^T); MN-major, when the depth runs down the rows
// (the keys of V in P.V).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that
// does not complete within ~2^33 cycles (seconds) traps, so that a
// pipeline fault ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) __trap();
  } while (!done);
}

// -------------------------------------------------------------------- TMA
// Load a box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion counts its bytes on `bar`. Coordinates past
// the tensor's extent read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Store a box from shared memory; the part past the tensor's extent is
// not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's plain shared-memory writes before later TMA reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over `count` threads (a multiple of 32) under id 1..15
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// byte offset of (row, col) in a 64-column slice written by a 128-byte
// swizzled TMA box (col counted in bf16 values)
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ------------------------------------------------------------------ wgmma
// Descriptor of a bf16 operand in a 128-byte swizzled tile: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1
// (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A descriptor is built once per use of a tile and stepped through the
// tile's k16 slices by adding to its start address field (kstep_*).

// K-major operand: the product's depth runs along the stored rows. 8-row
// groups are 1024 bytes apart (SBO); LBO is unused with this swizzle.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return make_desc(smem_u32(tile), 16, 1024);
}

// k16 step kk of a K-major tile of `rows` rows: its 32 bytes lie in
// 64-column slice kk / 4 at byte (kk % 4) * 32 of each row.
__device__ __forceinline__ uint64_t kstep_kmajor(uint64_t desc, int rows,
                                                 int kk) {
  return desc + (((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);
}

// MN-major operand of a tile of `rows` depth rows: the N extent crosses
// 64-column slices rows * 128 bytes apart (LBO); 8-row groups along the
// depth are 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile,
                                                 int rows) {
  return make_desc(smem_u32(tile), rows * 128, 1024);
}

// k16 step kk of an MN-major tile: depth rows 16 kk .. 16 kk + 15, 2048
// bytes further per step.
__device__ __forceinline__ uint64_t kstep_mnmajor(uint64_t desc, int kk) {
  return desc + kk * (2048 >> 4);
}

// The warp must be converged for the .aligned instructions that follow
// (its threads may have left an mbarrier wait on different iterations).
__device__ __forceinline__ void wgmma_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A fragments of register-A products: fenced after the wait, so that the
// compiler does not hand their registers to other values while an
// in-flight wgmma still reads them
template <int K>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (fp32, N / 2 registers a thread): thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and 8 more;
// register 4 j + 2 i + c is (that row + 8 i, column 8 j + 2 (t % 4) + c).
// The register A fragment of an m64k16 step is the same layout over its 16
// columns, so an accumulator's k16 slice kk becomes an A operand by packing
// registers 8 kk .. 8 kk + 7 pairwise (acc_to_a).
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory;
// accumulate = 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (the m64k16
// fragment, four bf16x2), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B),
        "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory;
// accumulate = 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers (the m64k16
// fragment, four bf16x2), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B),
        "r"(accumulate));
}

// d (+)= A . B over one k16 step, N in {64, 128}; TRANS_B = 0 for a
// K-major B, 1 for an MN-major B
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64<TRANS_B>(d, da, db, accumulate);
  else wgmma_ss_n128<TRANS_B>(d, da, db, accumulate);
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, db, accumulate);
  else wgmma_rs_n128<TRANS_B>(d, a, db, accumulate);
}

// -------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, L, H, D] tensor read through its (batch, seq,
// head) strides in elements (the head dim contiguous), as the 4-D tensor
// (D, L, H, B), with boxes of 64 head-dim values x `rows` rows of one head,
// 128-byte swizzled. Rows past L read as zeros and are not stored.
inline bool map_bf16_4d(CUtensorMap* map, const void* ptr, int B, int L,
                        int H, int D, int64_t sb, int64_t sl, int64_t sh,
                        int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
