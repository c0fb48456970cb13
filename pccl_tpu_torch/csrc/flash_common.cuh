// Shared pieces of the flash-attention kernels for Hopper (sm_90a).
//
// Layout: q, o, dq are [B, T, H, D] and k, v, dk, dv are [B, T, Hkv, D],
// contiguous bf16, the layout the model produces, so no transpose is needed
// around the kernels. lse and delta are [B, H, T] fp32. H is a multiple of
// Hkv (grouped-query attention: q head h reads kv head h / (H / Hkv)).
//
// Tiles are 64 rows by D columns, in shared memory, with rows padded by 8
// bf16 (4 fp32) so that the 16-row fragment loads of neighbouring rows fall
// on different banks. A block has 4 warps; warp w owns rows [16w, 16w+16) of
// the 64-row tile it iterates for, and computes its products with
// nvcuda::wmma bf16 16x16x16 fragments with fp32 accumulators.
//
// Why 64 x 64 with 4 warps: it keeps one block's shared memory at 70-125 KB
// (D = 64 or 128), so one or two blocks fit on an SM beside their registers,
// and the main path's shape (B=8, H=12, T=1024) gives 1536 blocks, about 12
// waves over 132 SMs. Larger tiles would cut the re-reads of K/V (each q tile
// reads all of K/V once) at the price of occupancy; that trade is for the
// wgmma/TMA redesign.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // q rows per tile
constexpr int BK = 64;            // k rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASK = -1e30f;    // the TPU kernels' mask fill
constexpr int LDS = 64 + 4;       // padded row of a 64-wide fp32 score tile
constexpr int LDP = 64 + 8;       // padded row of a 64-wide bf16 score tile

template <int D>
struct Tile {
    static constexpr int LD = D + 8;       // padded bf16 row of a [64, D] tile
    static constexpr int LDF = D + 4;      // padded fp32 row of a [64, D] tile
    static constexpr int BYTES = 64 * LD * 2;
    static constexpr int FBYTES = 64 * LDF * 4;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Global [B, T, Hn, D] row t of head h, batch b.
template <int D>
__device__ __forceinline__ size_t row_off(int b, int t, int h, int Hn, int T) {
    return ((static_cast<size_t>(b) * T + t) * Hn + h) * D;
}

// Copy rows [row0, row0 + 64) of head h into a padded [64, D] shared tile,
// 16 bytes a thread per step; rows at or past T are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int h, int Hn, int T, int row0) {
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
        const int r = i / CH, c = i % CH, t = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (t < T)
            val = *reinterpret_cast<const uint4*>(src + row_off<D>(b, t, h, Hn, T) + c * 8);
        *reinterpret_cast<uint4*>(dst + r * Tile<D>::LD + c * 8) = val;
    }
}

// Write a padded fp32 [64, D] shared tile to rows [row0, row0 + 64) of head
// h as bf16, skipping rows at or past T.
template <int D>
__device__ __forceinline__ void store_tile(bf16* dst, const float* src, int b,
                                           int h, int Hn, int T, int row0) {
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
        const int r = i / CH, c = i % CH, t = row0 + r;
        if (t >= T) continue;
        const float* s = src + r * Tile<D>::LDF + c * 8;
        __align__(16) bf16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(s[e]);
        *reinterpret_cast<uint4*>(dst + row_off<D>(b, t, h, Hn, T) + c * 8) =
            *reinterpret_cast<const uint4*>(out);
    }
}

// acc[j] (16 x 16, j < 4) = A[16, D] . B[64, D]^T for one warp: A rows from
// a padded [*, D] tile, B rows from another (read column-major, i.e. as B^T).
template <int D>
__device__ __forceinline__ void gemm_abt(FragC (&acc)[4], const bf16* a,
                                         const bf16* b) {
    constexpr int LD = Tile<D>::LD;
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + kk * 16, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            FragBCol fb;
            wmma::load_matrix_sync(fb, b + j * 16 * LD + kk * 16, LD);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
    }
}

// acc[n] (16 x 16, n < D/16) += P[16, 64] . B[64, D] for one warp: P rows
// from a padded bf16 [*, 64] tile, B from a padded [64, D] tile.
template <int D>
__device__ __forceinline__ void gemm_pb(FragC (&acc)[D / 16], const bf16* p,
                                        const bf16* b) {
    constexpr int LD = Tile<D>::LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        FragA fa;
        wmma::load_matrix_sync(fa, p + kk * 16, LDP);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
            FragBRow fb;
            wmma::load_matrix_sync(fb, b + kk * 16 * LD + n * 16, LD);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
    }
}

__device__ __forceinline__ void store_scores(float* s, FragC (&acc)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(s + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// Stage one warp's accumulators (its 16 rows of a [64, D] result) into a
// padded fp32 [64, D] tile.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, FragC (&acc)[D / 16]) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
        wmma::store_matrix_sync(dst + n * 16, acc[n], Tile<D>::LDF,
                                wmma::mem_row_major);
}

__device__ __forceinline__ bool visible(int qrow, int kcol, int T, int causal) {
    return qrow < T && kcol < T && (!causal || kcol <= qrow);
}

// Last k tile (exclusive) that q tile qt may see: the TPU kernels'
// _causal_nk with block_q = block_k = 64.
__device__ __forceinline__ int k_tiles(int qt, int T, int causal) {
    const int nk = (T + BK - 1) / BK;
    return causal ? min(nk, (qt * BQ + BQ + BK - 1) / BK) : nk;
}

}  // namespace flash
