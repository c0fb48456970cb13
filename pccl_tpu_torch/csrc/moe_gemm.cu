// Grouped GEMM over the experts of a dropless expert layer, for Hopper
// (sm_90a): the products of ops/moe.py's moe_topk (models/lfm2.py).
//
// Replaces no TPU kernel: the JAX package has no dropless expert layer, and
// its top-1 layer runs its experts as einsums over capacity buckets. Added
// because the expert layer's rows arrive sorted by expert in segments whose
// lengths the routing sets on the card: one plain product per expert would
// need those lengths on the host (a sync a layer) and 32 launches, and a
// padded batched product moves the padding.
//
// Three variants, one kernel template (bf16 operands, fp32 accumulation):
// - fwd: Y[s] = X[s] W_e for the rows s of expert e's segment
//   (X [S, K], W [E, K, N], Y [S, N] bf16);
// - dx:  dX[s] = dY[s] W_e^T (dY [S, N], dX [S, K] bf16);
// - dw:  dW_e = X_e^T dY_e, summed over the segment's rows (dW [E, K, N]
//   fp32, the gradient of the fp32 leaf; an empty segment writes zeros).
// The segments are offsets [E + 1] (int32, offsets[0] = 0, offsets[E] = S)
// read on the card. fwd and dx group the product's rows: the grid holds the
// most row tiles any routing can need, ceil(S / BM) + E (each segment wastes
// at most one partial tile), times the column tiles; each block finds its
// expert and tile by a scan over the offsets, and the blocks left over
// exit. dw groups the depth: one block per (expert, output tile) walks its
// segment's rows. No size on the host depends on the routing.
//
// What bounds it on the H100: at LFM2-8B-A1B's expert layer (B = 2, T =
// 8192, top 4: S = 65,536 rows; d 2048, f 1792) the gate-up product is
// 2 S d 2f = 0.96 TFLOP a variant (0.97 ms at 989 TFLOP/s) against 1.2 GB
// of operands and result (0.36 ms at 3.35 TB/s): bound by the tensor
// cores, as is the down product (half the work). So the design keeps
// wgmma, the only way to the tensor cores' full rate, fed:
// - a block computes a 128 x 256 tile (every output width of the model is a
//   multiple of 256, every dw height of 128) with 3 warpgroups: a producer,
//   cut to 24 registers by setmaxnreg, of which one thread issues TMA loads
//   of 64-deep operand tiles into a ring of 4 stages (48 KB each), and two
//   consumers (setmaxnreg 240, though ptxas keeps the kernel within 168)
//   that each own 64 rows and issue wgmma m64n256k16 on a stage once its
//   "full" mbarrier fires, the sum in 128 registers a thread, one group of
//   products kept in flight while the next stage is awaited;
// - operands in the 128-byte swizzled panels of hopper.cuh. fwd: A = X
//   K-major ([128 rows][64]), B = W_e MN-major (4 panels [64][64] of a 3D
//   map over [E, K, N]); dx: A = dY K-major, B = W_e^T K-major ([256 rows
//   of W_e][64] of the same 3D map); dw: A = X_e^T and B = dY_e, both
//   MN-major (2 and 4 panels [64 rows][64]), the depth running over the
//   segment's rows;
// - edges: columns and depth past K or N (multiples of 8) and rows past S
//   are TMA's zero fill. A fwd or dx row tile that crosses its segment's end
//   reads the next expert's rows: they are computed and never stored (the
//   epilogue masks rows per segment). A dw depth tile that crosses it would
//   add the next expert's rows, so the consumers zero those rows of A and B
//   in shared memory (then the async-proxy fence and a barrier of both)
//   before that tile's products;
// - the epilogue waits for both consumers' products, stages each
//   consumer's 64 rows in the ring's memory (bf16, or fp32 for dw) and
//   stores them 16 bytes a thread, rows and columns past the tile's end
//   skipped.
// At the expert layer's shapes above, on an H100 SXM at 700 W, the least
// time is 62-66 % of each variant's, which runs 1.25-1.35x faster than
// cuBLAS's bmm over segments padded to the busiest expert (PERF.md, 6).
// TMA maps are kernel parameters (__grid_constant__), built for each call;
// the kernel allocates nothing. Nothing crosses blocks and there are no
// atomics or split depths, so results are deterministic. Left for later: a
// persistent grid (the epilogue overlapping the next tile's loads) and
// clusters with multicast loads (less L2 traffic a tile).
#include <type_traits>

#include "hopper.cuh"

namespace moe_gemm {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;  // block tile, depth a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;                // producer warpgroup + 2 consumers
constexpr int GROUP_M = 0, GROUP_K = 1;
constexpr int LD = BN + 8;                  // staged row, elements (vs bank conflicts)

struct Smem {
    static constexpr int A_BYTES = BM * BK * 2;
    static constexpr int B_BYTES = BK * BN * 2;
    static constexpr int STAGE = A_BYTES + B_BYTES;  // every tile 1024-aligned
    static constexpr int OFF_BAR = STAGES * STAGE;
    static constexpr int BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;
    static_assert(2 * 64 * LD * 4 <= OFF_BAR, "the epilogue's staging fits in the ring");
};

// The two consumer warpgroups meet (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_bar() {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// C = A B over one group (see the top of the file). GROUP_M: rows [o_e,
// o_e+1) of A against B_e, depth K; GROUP_K: C_e = C + e strideC, the depth
// running over the segment's rows of A and B. M is C_e's height (GROUP_K),
// N the width of C.
template <int MODE, bool A_COL, bool B_COL, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
             void* __restrict__ C, const int* __restrict__ offsets, int E, int M, int N, int K,
             int64_t ldc, int64_t strideC) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::OFF_BAR);
    uint64_t* empty = full + STAGES;

    const int n0 = blockIdx.x * BN;
    int e, rows, depth;       // expert; valid rows of this C tile; the product's depth
    int r0;                   // GROUP_M: the tile's first row of A and C; GROUP_K: o_e
    int m0 = 0;               // GROUP_K: the tile's first row of C_e
    if (MODE == GROUP_M) {
        int t = blockIdx.y;
        e = -1;
        for (int i = 0; i < E; ++i) {
            const int tiles = (offsets[i + 1] - offsets[i] + BM - 1) / BM;
            if (t < tiles) {
                e = i;
                break;
            }
            t -= tiles;
        }
        if (e < 0) return;    // a tile no routing of these rows reaches
        r0 = offsets[e] + t * BM;
        rows = min(BM, offsets[e + 1] - r0);
        depth = K;
    } else {
        e = blockIdx.z;
        r0 = offsets[e];
        depth = offsets[e + 1] - r0;
        m0 = blockIdx.y * BM;
        rows = min(BM, M - m0);
    }
    const int nk = (depth + BK - 1) / BK;
    // warp-uniform for the compiler too, as the role split needs
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);  // every consumer thread
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == 0) {
        // ---- producer
        reg_dealloc<24>();
        if (threadIdx.x == 0 && nk > 0) {
            prefetch_map(&tm_a);
            prefetch_map(&tm_b);
            Ring<STAGES> ring;
            for (int kt = 0; kt < nk; ++kt) {
                const int s = ring.stage, k0 = kt * BK;
                bf16* sa = reinterpret_cast<bf16*>(smem + s * Smem::STAGE);
                bf16* sb = reinterpret_cast<bf16*>(smem + s * Smem::STAGE + Smem::A_BYTES);
                mbar_wait(&empty[s], ring.phase ^ 1u);
                mbar_expect_tx(&full[s], Smem::STAGE);
                if (MODE == GROUP_M) {
                    tma_load_2d(sa, &tm_a, &full[s], k0, r0);
                    if (B_COL) {
                        tma_load_3d(sb, &tm_b, &full[s], k0, n0, e);
                    } else {
#pragma unroll
                        for (int p = 0; p < BN / 64; ++p)
                            tma_load_3d(sb + p * BK * 64, &tm_b, &full[s], n0 + 64 * p, k0, e);
                    }
                } else {
#pragma unroll
                    for (int p = 0; p < BM / 64; ++p)
                        tma_load_2d(sa + p * BK * 64, &tm_a, &full[s], m0 + 64 * p, r0 + k0);
#pragma unroll
                    for (int p = 0; p < BN / 64; ++p)
                        tma_load_2d(sb + p * BK * 64, &tm_b, &full[s], n0 + 64 * p, r0 + k0);
                }
                ring.next();
            }
        }
    } else {
        // ---- consumers: c owns rows [64c, 64c + 64) of the tile
        reg_alloc<240>();
        const int c = wg - 1;
        const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

        Ring<STAGES> ring;
        int prev = -1;
        for (int kt = 0; kt < nk; ++kt) {
            const int st = ring.stage;
            bf16* sa = reinterpret_cast<bf16*>(smem + st * Smem::STAGE);
            bf16* sb = reinterpret_cast<bf16*>(smem + st * Smem::STAGE + Smem::A_BYTES);
            mbar_wait(&full[st], ring.phase);
            const int valid = depth - kt * BK;
            if (MODE == GROUP_K && valid < BK) {
                // the next segment's rows: consumer c zeros them in its A
                // panel and in B panels 2c and 2c + 1 (a panel row is 128
                // bytes whatever the swizzle). No division here: its
                // temporaries, with the previous stage's wgmma in flight,
                // made ptxas serialize every wgmma of this variant (C7515).
                unsigned char* panels[3] = {
                    reinterpret_cast<unsigned char*>(sa + c * BK * 64),
                    reinterpret_cast<unsigned char*>(sb + 2 * c * BK * 64),
                    reinterpret_cast<unsigned char*>(sb + (2 * c + 1) * BK * 64)};
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    for (int off = valid * 128 + t * 16; off < BK * 128; off += 128 * 16)
                        *reinterpret_cast<uint4*>(panels[p] + off) = make_uint4(0u, 0u, 0u, 0u);
                fence_proxy_async();
                consumers_bar();
            }
            const uint64_t da = A_COL ? desc_mnmajor<BK>(sa + c * BK * 64) : desc_kmajor(sa, 64 * c);
            const uint64_t db = B_COL ? desc_kmajor(sb, 0) : desc_mnmajor<BK>(sb);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_ss<A_COL ? 1 : 0, B_COL ? 0 : 1>(
                    acc, A_COL ? mnmajor_step(da, kk) : kmajor_step<BM>(da, kk),
                    B_COL ? kmajor_step<BN>(db, kk) : mnmajor_step(db, kk), 1);
            wg_commit();
            wg_wait<1>();  // the previous stage's products are done: release it
            if (prev >= 0) mbar_arrive(&empty[prev]);
            prev = st;
            ring.next();
        }
        wg_wait<0>();
        fence_regs(acc);

        // epilogue: both consumers' products are done, so the ring's memory
        // is free; each stages its 64 rows there and stores 16 bytes a thread
        consumers_bar();
        using Out = typename std::conditional<OUT_F32, float, bf16>::type;
        Out* stage = reinterpret_cast<Out*>(smem) + c * 64 * LD;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
            const int r = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
            const int col = 8 * (i / 4) + 2 * (lane % 4);
            if (OUT_F32)
                *reinterpret_cast<float2*>(stage + r * LD + col) = make_float2(acc[i], acc[i + 1]);
            else
                *reinterpret_cast<__nv_bfloat162*>(stage + r * LD + col) =
                    __floats2bfloat162_rn(acc[i], acc[i + 1]);
        }
        wg_bar(2 + c);
        constexpr int PER = 16 / sizeof(Out), CHUNKS = BN / PER;
        const int my_rows = rows - 64 * c, cols = min(BN, N - n0);
        Out* dst = static_cast<Out*>(C) + (MODE == GROUP_M ? 0 : e * strideC) +
                   static_cast<int64_t>(MODE == GROUP_M ? r0 : m0) * ldc + n0;
        for (int idx = t; idx < 64 * CHUNKS; idx += 128) {
            const int r = idx / CHUNKS, col = (idx % CHUNKS) * PER;
            if (r < my_rows && col < cols)
                *reinterpret_cast<uint4*>(dst + (64 * c + r) * ldc + col) =
                    *reinterpret_cast<const uint4*>(stage + r * LD + col);
        }
    }
}

// rows x cols bf16, row-major, read in boxes of 64 columns x `box_rows`
int map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {2ull * cols};
    const cuuint32_t box[2] = {64u, static_cast<cuuint32_t>(box_rows)};
    return make_map_nd(map, base, 2, dims, strides, box);
}

// E matrices of rows x cols bf16, read in boxes of 64 columns x `box_rows` of one
int map_3d(CUtensorMap* map, const void* base, int E, int rows, int cols, int box_rows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(E)};
    const cuuint64_t strides[2] = {2ull * cols, 2ull * rows * cols};
    const cuuint32_t box[3] = {64u, static_cast<cuuint32_t>(box_rows), 1u};
    return make_map_nd(map, base, 3, dims, strides, box);
}

template <int MODE, bool A_COL, bool B_COL, bool OUT_F32>
int launch(dim3 grid, const CUtensorMap& ta, const CUtensorMap& tb, void* C, const void* offsets,
           int E, int M, int N, int K, int64_t ldc, int64_t strideC, void* stream) {
    if (int err = allow_smem<grouped_gemm<MODE, A_COL, B_COL, OUT_F32>>(Smem::BYTES)) return err;
    grouped_gemm<MODE, A_COL, B_COL, OUT_F32>
        <<<grid, THREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
            ta, tb, C, static_cast<const int*>(offsets), E, M, N, K, ldc, strideC);
    return static_cast<int>(cudaGetLastError());
}

bool bad(int E, int S, int K, int N) {
    return E <= 0 || S < 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
           (S + BM - 1) / BM + E > 65535 || E > 65535;
}

}  // namespace moe_gemm

using moe_gemm::BM;
using moe_gemm::BN;
using moe_gemm::BK;

// With no rows (S = 0) no block loads an operand, so the maps stay zeros:
// a map is never built over an empty tensor.

// y [S, N] = x [S, K] @ w[e] [K, N] over each expert's rows
extern "C" int pccl_moe_gemm_fwd(const void* x, const void* w, void* y, const void* offsets,
                                 int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ta{}, tb{};
    if (S > 0) {
        if (int err = moe_gemm::map_2d(&ta, x, S, K, BM)) return err;
        if (int err = moe_gemm::map_3d(&tb, w, E, K, N, BK)) return err;
    }
    dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM + E);
    return moe_gemm::launch<moe_gemm::GROUP_M, false, false, false>(
        grid, ta, tb, y, offsets, E, S, N, K, N, 0, stream);
}

// dx [S, K] = dy [S, N] @ w[e]^T over each expert's rows
extern "C" int pccl_moe_gemm_dx(const void* dy, const void* w, void* dx, const void* offsets,
                                int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ta{}, tb{};
    if (S > 0) {
        if (int err = moe_gemm::map_2d(&ta, dy, S, N, BM)) return err;
        if (int err = moe_gemm::map_3d(&tb, w, E, K, N, BN)) return err;
    }
    dim3 grid((K + BN - 1) / BN, (S + BM - 1) / BM + E);
    return moe_gemm::launch<moe_gemm::GROUP_M, false, true, false>(
        grid, ta, tb, dx, offsets, E, S, K, N, K, 0, stream);
}

// dw[e] [K, N] = x_e^T [K, rows] @ dy_e [rows, N], fp32, zeros for an empty segment
extern "C" int pccl_moe_gemm_dw(const void* x, const void* dy, void* dw, const void* offsets,
                                int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ta{}, tb{};
    if (S > 0) {
        if (int err = moe_gemm::map_2d(&ta, x, S, K, BK)) return err;
        if (int err = moe_gemm::map_2d(&tb, dy, S, N, BK)) return err;
    }
    dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
    return moe_gemm::launch<moe_gemm::GROUP_K, true, false, true>(
        grid, ta, tb, dw, offsets, E, K, N, 0, N, int64_t(K) * N, stream);
}
