// Hopper (sm_90a) building blocks of the flash-attention kernels and the
// experts' grouped GEMM: TMA tensor maps and loads, mbarriers, wgmma with
// its shared-memory descriptors, setmaxnreg, named barriers, and the
// row-store epilogue.
//
// Operand tiles in shared memory. A tile of R rows of one head of a
// [B, T, Hn, D] bf16 tensor is loaded by TMA as D/64 panels of [R, 64]
// (128-byte rows, 128-byte swizzle), panel p at p * R * 128 bytes; every
// panel starts on a 1024-byte boundary, the period of the swizzle. The
// same panel layout serves wgmma both ways:
// - K-major (the product's depth runs along D, as Q and K in Q.K^T): an
//   8-row group is one 1024-byte swizzle atom (SBO = 1024); a k16 step is
//   +32 bytes inside a panel, and steps 4..7 (Dh = 128) move to the next
//   panel's start;
// - MN-major (the depth runs along the rows, as V in P.V; the transpose
//   bit is set): an 8-row group along the depth is one atom (SBO = 1024),
//   the next 64 columns are the next panel (LBO = R * 128), and a k16 step
//   is 16 rows, +2048 bytes.
// Head dims below 64 (16 and 32) use the same layout at a padded width of
// 64: the tensor map keeps the true D as its inner dimension and stride,
// and its 64-column box reads columns D..63 as zeros (OOB fill), so every
// product runs at depth or width 64, the zero columns add nothing to
// Q.K^T, dO.V^T, dS.K, dS^T.Q or P^T.dO, the extra columns of P.V are
// zeros, and the epilogue stores only the D true columns.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ host: TMA maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library does not link
// libcuda.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                cudaEnableDefault, &found);
#endif
        if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The map of a bf16 tensor of `rank` (up to 4) dims at `base`, innermost
// first, with byte strides of the outer rank - 1 dims, read in boxes of
// `box` elements a dim (the innermost 64: one 128-byte row of the 128-byte
// swizzle). Elements past a dim's end read as zeros; a box's bytes count in
// full toward the mbarrier's transaction count either way. Returns a
// cudaError_t (0 = built). The map holds the address, so it is built for
// every call.
inline int make_map_nd(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                           const_cast<void*>(base), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of one [B, T, Hn, D] bf16 operand at `base`: dims (D, Hn, T, B),
// boxes of 64 columns x 1 head x `rows` rows x 1 batch; rows past T and
// columns past D (D = 16 or 32) read as zeros.
inline int make_map(CUtensorMap* map, const void* base, int B, int T, int Hn,
                    int D, int rows) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hn),
                                static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {2ull * D, 2ull * Hn * D, 2ull * T * Hn * D};
    const cuuint32_t box[4] = {64u, 1u, static_cast<cuuint32_t>(rows), 1u};
    return make_map_nd(map, base, 4, dims, strides, box);
}

// Raise kernel K's dynamic shared-memory limit to `bytes` on the current
// device. The attribute holds for the process, so it is set once per device
// (the first 64), not on every launch. Internal linkage: a template's static
// would otherwise be one symbol shared by every loaded library with the same
// kernel, and a second build of it would skip its own attribute.
namespace {
template <auto K>
int allow_smem(size_t bytes) {
    constexpr int kDevices = 64;
    static std::atomic<bool> set[kDevices];
    int dev = 0;
    if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    const bool known = dev < kDevices;
    if (known && set[dev].load(std::memory_order_acquire)) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e == cudaSuccess && known) set[dev].store(true, std::memory_order_release);
    return static_cast<int>(e);
}
}  // namespace

// ------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary (the 128-byte swizzle's period) at or after
// the dynamic shared memory `raw`. It is reached by an offset from `raw`, not
// by rounding the pointer as an integer, so that the compiler still knows it
// points to shared memory: accesses through it are then LDS and STS, not
// generic loads and stores with 64-bit addresses.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
    return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// --- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// After every mbar_init, before any thread uses the barriers (then a
// __syncthreads).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait until the barrier's phase differs from `parity`. A wait of 10 s can
// only be a pipeline whose sides disagree; it traps, so that the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try_wait(addr, parity))
        if (global_ns() - t0 > 10000000000ull) __trap();
}

// Stage and phase of a ring of S stages. A consumer waits for "full" with
// `phase`; the producer waits for "empty" with `phase ^ 1`, so its first
// pass over the ring does not wait.
template <int S>
struct Ring {
    int stage = 0;
    uint32_t phase = 0;
    __device__ __forceinline__ void next() {
        if (++stage == S) {
            stage = 0;
            phase ^= 1u;
        }
    }
};

// --- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Orders this thread's earlier writes to shared memory before later reads of
// it by the async proxy (wgmma, TMA); then a barrier among the readers.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// Rows [row0, row0 + R) of head h, batch b, as D/64 panels of [R, 64].
template <int D, int R>
__device__ __forceinline__ void tma_load_rows(bf16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int b, int h, int row0) {
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
        tma_load_4d(dst + p * R * 64, map, bar, p * 64, h, row0, b);
}

// --- wgmma

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma writes or reads, so that the
// compiler moves no access to them across a wg_wait or a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand starting at
// p (offsets in bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
    uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
    d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
    d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
    d |= 1ull << 62;  // 128-byte swizzle
    return d;
}

// The descriptor of a K-major operand, rows from r0 of a panel tile of R
// rows, and of an MN-major one (a whole panel tile of R rows). Each is
// passed through an empty asm, so that the compiler cannot hoist the
// descriptors of every k16 step out of the loop that builds them: that
// would hold 2 registers a step, which the accumulators need.
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile, int r0) {
    uint64_t d = smem_desc(tile + r0 * 64, 16, 1024);
    asm volatile("" : "+l"(d));
    return d;
}

template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile) {
    uint64_t d = smem_desc(tile, R * 128, 1024);
    asm volatile("" : "+l"(d));
    return d;
}

// k16 step kk of those descriptors (the address field counts 16 bytes).
template <int R>
__device__ __forceinline__ uint64_t kmajor_step(uint64_t d, int kk) {
    return d + (((kk / 4) * R * 128 + (kk % 4) * 32) >> 4);
}

__device__ __forceinline__ uint64_t mnmajor_step(uint64_t d, int kk) {
    return d + ((kk * 16 * 128) >> 4);
}

// m64nNk16, bf16 x bf16 -> fp32, d += a . b (d = a . b when scale_d is 0).
// wgmma_ss: a and b from shared memory (TA/TB: 1 = MN-major); wgmma_rs: a
// from registers, in the layout of the accumulator's columns (see
// pack_a). d[i] of thread t of the warpgroup is row 16 (t/32) + (t%32)/4 +
// 8 ((i/2)%2), column 8 (i/4) + 2 (t%4) + i%2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Accumulator columns [16 kk, 16 kk + 16) of an m64 tile as the register A
// operand of the next product, rounded to bf16.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
        a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
        a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
        a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
    }
}

// --- registers and barriers

// A warpgroup gives registers back to (dealloc) or takes them from (alloc)
// the block's pool; every thread of the warpgroup runs it. ptxas may not use
// the registers alloc grants: check the ptxas report and the SASS.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Barrier `id` (1..15; 0 is __syncthreads) among one warpgroup.
__device__ __forceinline__ void wg_bar(int id) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// --- epilogue

// Store one warpgroup's m64 x D accumulator, row r scaled by mul[(i/2)%2]
// of its thread, as bf16 rows [row0, row0 + 64) of `dst` (row t at
// dst + t * stride), skipping rows at or past T; only its first `cols`
// columns (the true head dim, a multiple of 8 up to D) are stored. Goes
// through `stage` ([64, D + 8] bf16) so that the global stores are 16
// bytes a thread; the warpgroup meets at barrier `bar` before and after.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float mul0,
                                           float mul1, bf16* stage, bf16* dst,
                                           size_t stride, int row0, int T, int cols,
                                           int bar) {
    constexpr int LD = D + 8;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int r = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        const float m = (i / 2) % 2 ? mul1 : mul0;
        *reinterpret_cast<__nv_bfloat162*>(stage + r * LD + c) =
            __floats2bfloat162_rn(acc[i] * m, acc[i + 1] * m);
    }
    wg_bar(bar);
    const int chunks = cols / 8;
    for (int idx = t; idx < 64 * chunks; idx += 128) {
        const int r = idx / chunks, ch = idx % chunks;
        if (row0 + r < T)
            *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * stride + ch * 8) =
                *reinterpret_cast<const uint4*>(stage + r * LD + ch * 8);
    }
    wg_bar(bar);
}

}  // namespace hopper
