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
// cores, as is the down product (half the work). This first design is
// right and simple, not fast: a block computes a 128 x 128 tile with 8
// warps (each 32 x 64) by warp-level mma.sync (nvcuda::wmma 16 x 16 x 16),
// operand tiles of depth 32 double-buffered in shared memory by cp.async (16-byte copies, rows past a
// segment's end or columns past the edge zero-filled), the epilogue staged
// a 16 x 16 fragment at a time through shared memory. Left for later: wgmma
// with TMA (hopper.cuh's pieces), a persistent grid, and splitting a long
// segment's dw over several blocks. Nothing crosses blocks and there are no
// atomics, so results are deterministic.
#include <mma.h>

#include <type_traits>

#include "hopper.cuh"

namespace moe_gemm {

using hopper::bf16;
using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;  // block tile, depth a stage
constexpr int THREADS = 256;                // 8 warps: 4 along M, 2 along N
constexpr int PAD = 8;                      // bf16 elements a smem row, vs bank conflicts
constexpr int GROUP_M = 0, GROUP_K = 1;

// a shared-memory tile of R rows of C contiguous bf16, padded rows
template <int R, int C>
struct Tile {
    static constexpr int ROWS = R, COLS = C, LD = C + PAD, BYTES = R * LD * 2;
};

template <bool A_COL, bool B_COL>
struct Smem {
    // A(m, k): row-major [BM][BK], or col-major stored [BK][BM]
    using TA = Tile<A_COL ? BK : BM, A_COL ? BM : BK>;
    // B(k, n): row-major [BK][BN], or col-major stored [BN][BK]
    using TB = Tile<B_COL ? BN : BK, B_COL ? BK : BN>;
    static constexpr int STAGE = TA::BYTES + TB::BYTES;  // a multiple of 32
    static constexpr int BYTES = 2 * STAGE;
    static_assert(BYTES >= (THREADS / 32) * 16 * 16 * 4, "epilogue staging");
    static_assert(BYTES <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"(hopper::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy tile T (rows of T::COLS contiguous elements, row stride ld in
// global memory) from g; zeros where row >= row_lim or col >= col_lim.
// col_lim is a multiple of 8, so a 16-byte chunk is all in or all out;
// `safe` is an address inside the tensor, given for the chunks left out.
template <class T>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld, int row_lim,
                                          int col_lim, const bf16* safe) {
    constexpr int PER_ROW = T::COLS / 8;
    for (int c = threadIdx.x; c < T::ROWS * PER_ROW; c += THREADS) {
        const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
        const bool ok = r < row_lim && col < col_lim;
        cp16(s + r * T::LD + col, ok ? g + r * ld + col : safe, ok);
    }
}

// C = A B over one group (see the top of the file). GROUP_M: rows [o_e,
// o_e+1) of A (row-major, lda) and C against B_e = B + e strideB; GROUP_K:
// C_e = C + e strideC, the depth running over the segment's rows of A
// (col-major, lda) and B (row-major, ldb).
template <int MODE, bool A_COL, bool B_COL, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
grouped_gemm(const bf16* __restrict__ A, const bf16* __restrict__ B, void* __restrict__ C,
             const int* __restrict__ offsets, int E, int M, int N, int K, int64_t lda,
             int64_t ldb, int64_t ldc, int64_t strideB, int64_t strideC) {
    using S = Smem<A_COL, B_COL>;
    using TA = typename S::TA;
    using TB = typename S::TB;
    __shared__ __align__(128) unsigned char smem[S::BYTES];

    const int n0 = blockIdx.x * BN;
    int rows, depth;          // valid rows of this C tile; the product's depth
    int m0 = 0;               // GROUP_K: the tile's first row of C_e
    const bf16 *a, *b;
    int64_t c_off;            // element offset of the tile's row 0 in C
    if (MODE == GROUP_M) {
        int t = blockIdx.y, e = -1;
        for (int i = 0; i < E; ++i) {
            const int tiles = (offsets[i + 1] - offsets[i] + BM - 1) / BM;
            if (t < tiles) {
                e = i;
                break;
            }
            t -= tiles;
        }
        if (e < 0) return;    // a tile no routing of these rows reaches
        const int row0 = offsets[e] + t * BM;
        rows = min(BM, offsets[e + 1] - row0);
        depth = K;
        a = A + row0 * lda;
        b = B + e * strideB;
        c_off = row0 * ldc;
    } else {
        const int e = blockIdx.z, s0 = offsets[e];
        depth = offsets[e + 1] - s0;
        m0 = blockIdx.y * BM;
        rows = min(BM, M - m0);
        a = A + s0 * lda + m0;
        b = B + s0 * ldb;
        c_off = e * strideC + m0 * ldc;
    }

    auto load = [&](int stage, int k0) {
        bf16* sa = reinterpret_cast<bf16*>(smem + stage * S::STAGE);
        bf16* sb = reinterpret_cast<bf16*>(smem + stage * S::STAGE + TA::BYTES);
        if (A_COL)
            load_tile<TA>(sa, a + k0 * lda, lda, depth - k0, M - m0, A);
        else
            load_tile<TA>(sa, a + k0, lda, rows, depth - k0, A);
        if (B_COL)
            load_tile<TB>(sb, b + n0 * ldb + k0, ldb, N - n0, depth - k0, B);
        else
            load_tile<TB>(sb, b + k0 * ldb + n0, ldb, depth - k0, N - n0, B);
    };

    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    const int nk = (depth + BK - 1) / BK;
    if (nk > 0) {
        load(0, 0);
        cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
            load((kt + 1) & 1, (kt + 1) * BK);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        const bf16* sa = reinterpret_cast<const bf16*>(smem + (kt & 1) * S::STAGE);
        const bf16* sb = reinterpret_cast<const bf16*>(smem + (kt & 1) * S::STAGE + TA::BYTES);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int m = wm * 32 + i * 16;
                wmma::load_matrix_sync(fa[i], A_COL ? sa + kk * TA::LD + m : sa + m * TA::LD + kk,
                                       TA::LD);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = wn * 64 + j * 16;
                wmma::load_matrix_sync(fb[j], B_COL ? sb + n * TB::LD + kk : sb + kk * TB::LD + n,
                                       TB::LD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue: each warp stages one 16 x 16 fragment in shared memory, and
    // each lane stores 8 columns of one of its rows
    float* stage = reinterpret_cast<float*>(smem) + warp * 256;
    const int lane = threadIdx.x % 32, r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int row = wm * 32 + i * 16 + r, col = n0 + wn * 64 + j * 16 + cc;
            if (row < rows && col < N) {
                const float* v = stage + r * 16 + cc;
                const int64_t at = c_off + row * ldc + col;
                if (OUT_F32) {
                    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(C) + at);
                    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
                    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
                } else {
                    uint4 packed;
                    packed.x = hopper::pack_bf16(v[0], v[1]);
                    packed.y = hopper::pack_bf16(v[2], v[3]);
                    packed.z = hopper::pack_bf16(v[4], v[5]);
                    packed.w = hopper::pack_bf16(v[6], v[7]);
                    *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + at) = packed;
                }
            }
            __syncwarp();
        }
}

template <int MODE, bool A_COL, bool B_COL, bool OUT_F32>
int launch(dim3 grid, const void* A, const void* B, void* C, const void* offsets, int E,
           int M, int N, int K, int64_t lda, int64_t ldb, int64_t ldc, int64_t strideB,
           int64_t strideC, void* stream) {
    grouped_gemm<MODE, A_COL, B_COL, OUT_F32>
        <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const bf16*>(A), static_cast<const bf16*>(B), C,
            static_cast<const int*>(offsets), E, M, N, K, lda, ldb, ldc, strideB, strideC);
    return static_cast<int>(cudaGetLastError());
}

bool bad(int E, int S, int K, int N) {
    return E <= 0 || S < 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
           (S + BM - 1) / BM + E > 65535;
}

}  // namespace moe_gemm

using moe_gemm::BM;
using moe_gemm::BN;

// y [S, N] = x [S, K] @ w[e] [K, N] over each expert's rows
extern "C" int pccl_moe_gemm_fwd(const void* x, const void* w, void* y, const void* offsets,
                                 int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM + E);
    return moe_gemm::launch<moe_gemm::GROUP_M, false, false, false>(
        grid, x, w, y, offsets, E, S, N, K, K, N, N, int64_t(K) * N, 0, stream);
}

// dx [S, K] = dy [S, N] @ w[e]^T over each expert's rows
extern "C" int pccl_moe_gemm_dx(const void* dy, const void* w, void* dx, const void* offsets,
                                int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((K + BN - 1) / BN, (S + BM - 1) / BM + E);
    return moe_gemm::launch<moe_gemm::GROUP_M, false, true, false>(
        grid, dy, w, dx, offsets, E, S, K, N, N, N, K, int64_t(K) * N, 0, stream);
}

// dw[e] [K, N] = x_e^T [K, rows] @ dy_e [rows, N], fp32, zeros for an empty segment
extern "C" int pccl_moe_gemm_dw(const void* x, const void* dy, void* dw, const void* offsets,
                                int E, int S, int K, int N, void* stream) {
    if (moe_gemm::bad(E, S, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
    return moe_gemm::launch<moe_gemm::GROUP_K, true, false, true>(
        grid, x, dy, dw, offsets, E, K, N, 0, K, N, N, 0, int64_t(K) * N, stream);
}
