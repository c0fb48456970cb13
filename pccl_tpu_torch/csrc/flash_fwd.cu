// Flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// pccl_tpu/ops/flash_attention.py (reached through `_flash_bhtd`'s
// pl.pallas_call). Same function: online softmax over k tiles with a running
// max m, normalizer l and an fp32 accumulator; o = acc / l, lse = m + log l;
// scores masked with -1e30; P cast to bf16 before P.V.
//
// Design: one block per (batch*head, q tile of 64 rows). The TPU grid's
// sequential k dimension, which carried m, l and acc in scratch, becomes a
// loop inside the block, so nothing crosses blocks and the result is
// deterministic. Causal k tiles past the diagonal are never visited. Rows
// and columns at or past T are masked in the kernel, so any T runs
// (non-causal too); there is no dense fallback.
//
// What bounds it on the H100: at T = 1024, D = 64 the kernel does
// 4*T*T*D/2 FLOPs a head (causal) against 4 reads of T*D bf16, so it is
// bound by operations (989 TFLOP/s bf16 dense). This simple version cannot
// reach that: wmma 16x16x16 (mma.sync) runs well below the wgmma rate,
// tiles are copied with plain loads (no TMA, no cp.async pipelining), so
// loads and products do not overlap, and the softmax goes through shared
// memory. Left for later: wgmma on 64-row warpgroup tiles, TMA with a
// multi-stage mbarrier ring, warp specialisation, the accumulator kept in
// registers.
#include "flash_common.cuh"

namespace flash {

template <int D>
constexpr size_t fwd_smem() {
    // sQ, sK, sV (bf16 [64, D]) + sP (bf16 [64, 64]) + sS (fp32 [64, 64])
    // + sO (fp32 [64, D])
    return 3 * Tile<D>::BYTES + 64 * LDP * 2 + 64 * LDS * 4 + Tile<D>::FBYTES;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int Hkv, int causal,
                 float scale) {
    constexpr int LD = Tile<D>::LD, LDO = Tile<D>::LDF;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = sQ + 64 * LD;
    bf16* sV = sK + 64 * LD;
    bf16* sP = sV + 64 * LD;
    float* sS = reinterpret_cast<float*>(sP + 64 * LDP);
    float* sO = sS + 64 * LDS;

    const int nq = (T + BQ - 1) / BQ;
    const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // softmax phase: lanes 2r and 2r+1 share row r of the warp's 16 rows,
    // each taking every other column
    const int row = warp * 16 + (lane >> 1), half = lane & 1, qrow = q0 + row;

    load_tile<D>(sQ, q, b, h, H, T, q0);
    for (int i = threadIdx.x; i < 64 * LDO; i += NTHREADS) sO[i] = 0.0f;
    float m = MASK, l = 0.0f;

    const int nk = k_tiles(qt, T, causal);
    for (int kt = 0; kt < nk; ++kt) {
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<D>(sK, k, b, hk, Hkv, T, kt * BK);
        load_tile<D>(sV, v, b, hk, Hkv, T, kt * BK);
        __syncthreads();
        {
            FragC acc[4];
            gemm_abt<D>(acc, sQ + warp * 16 * LD, sK);
            store_scores(sS + warp * 16 * LDS, acc);
        }
        __syncwarp();
        float* srow = sS + row * LDS;
        bf16* prow = sP + row * LDP;
        float mx = MASK;
        for (int c = half; c < BK; c += 2) {
            const float s = visible(qrow, kt * BK + c, T, causal) ? srow[c] * scale : MASK;
            srow[c] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);
        const float corr = __expf(m - m_new);
        float sum = 0.0f;
        for (int c = half; c < BK; c += 2) {
            const float p = __expf(srow[c] - m_new);
            sum += p;
            prow[c] = __float2bfloat16(p);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l = l * corr + sum;
        m = m_new;
        float* orow = sO + row * LDO;
        for (int c = half; c < D; c += 2) orow[c] *= corr;
        __syncwarp();
        {
            FragC acc[D / 16];
#pragma unroll
            for (int n = 0; n < D / 16; ++n)
                wmma::load_matrix_sync(acc[n], sO + warp * 16 * LDO + n * 16, LDO,
                                       wmma::mem_row_major);
            gemm_pb<D>(acc, sP + warp * 16 * LDP, sV);
            stage_rows<D>(sO + warp * 16 * LDO, acc);
        }
        __syncwarp();
    }

    float* orow = sO + row * LDO;
    for (int c = half; c < D; c += 2) orow[c] = orow[c] / l;
    if (half == 0 && qrow < T) lse[static_cast<size_t>(bh) * T + qrow] = m + logf(l);
    __syncthreads();
    store_tile<D>(o, sO, b, h, H, T, q0);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int T, int H, int Hkv, int causal, cudaStream_t stream) {
    constexpr size_t smem = fwd_smem<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), T, H, Hkv, causal, 1.0f / sqrtf(static_cast<float>(D)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q [B,T,H,D], k/v [B,T,Hkv,D] bf16 -> o [B,T,H,D] bf16, lse [B,H,T] fp32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int pccl_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int Hkv,
                              int D, int causal, void* stream) {
    if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 64) return flash::launch_fwd<64>(q, k, v, o, lse, B, T, H, Hkv, causal, s);
    if (D == 128) return flash::launch_fwd<128>(q, k, v, o, lse, B, T, H, Hkv, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
