// Flash-attention backward for Hopper (sm_90a): K2 (dq) and K3 (dk, dv).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// of pccl_tpu/ops/flash_attention.py (the two pl.pallas_call sites of
// `_flash_bwd_bhtd`). Same function: both rebuild p = exp(s - lse) from the
// forward's log-sum-exp, and with delta = rowsum(do * o) (computed by the
// caller in fp32, minus dlse when the lse has a cotangent)
//     ds = p * (do . v^T - delta) * scale, cast to bf16,
//     dq = sum_k ds . k,   dv = sum_q p^T . do,   dk = sum_q ds^T . q,
// with fp32 accumulation and the -1e30 mask of the forward.
//
// Design:
// - K2: one block per (batch*head, q tile of 64 rows), looping over the k
//   tiles the causal bound lets it see. dq accumulates in wmma accumulator
//   fragments (registers) and is written once.
// - K3: one block per (batch*kv head, k tile of 64 rows), looping over the G
//   q heads that share the kv head and over the q tiles from the causal
//   start j0 on. dk and dv accumulate in registers and are written once.
// The TPU grid carried dq (and dk, dv) across sequential grid steps; here
// those steps are loops inside one block, so no atomics are needed and the
// result is deterministic. Rows and columns at or past T are masked.
//
// What bounds them on the H100: K2 does 3 and K3 4 products of
// 2*64*64*D FLOPs per tile pair, so at the main path's shape both are bound
// by operations, like the forward. This simple version has the same limits
// as the forward (wmma fragments, plain synchronous tile loads, scores
// through shared memory) and recomputes s and dp in both kernels. Left for
// later: wgmma/TMA pipelines, and a single fused pass that writes dq with
// atomics or a second reduction pass.
#include "flash_common.cuh"

namespace flash {

template <int D>
constexpr size_t dq_smem() {
    // sQ, sdO, sK, sV (bf16 [64, D]) + sdS (bf16 [64, 64])
    // + sS, sdP (fp32 [64, 64], contiguous: the dq staging tile reuses them)
    return 4 * Tile<D>::BYTES + 64 * LDP * 2 + 2 * 64 * LDS * 4;
}

template <int D>
constexpr size_t dkv_smem() {
    // sK, sV, sQ, sdO (bf16 [64, D]) + sPt, sdSt (bf16 [64, 64])
    // + sSt, sdPt (fp32 [64, 64], contiguous: reused to stage dk and dv)
    // + lse, delta of the q tile (fp32 [64] each)
    return 4 * Tile<D>::BYTES + 2 * 64 * LDP * 2 + 2 * 64 * LDS * 4 + 2 * 64 * 4;
}

static_assert(2 * 64 * LDS * 4 >= Tile<128>::FBYTES, "staging tile must fit");

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int H, int Hkv, int causal,
                    float scale) {
    constexpr int LD = Tile<D>::LD;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sdO = sQ + 64 * LD;
    bf16* sK = sdO + 64 * LD;
    bf16* sV = sK + 64 * LD;
    bf16* sdS = sV + 64 * LD;
    float* sS = reinterpret_cast<float*>(sdS + 64 * LDP);
    float* sdP = sS + 64 * LDS;

    const int nq = (T + BQ - 1) / BQ;
    const int qt = nq - 1 - static_cast<int>(blockIdx.x);
    const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = warp * 16 + (lane >> 1), half = lane & 1, qrow = q0 + row;

    load_tile<D>(sQ, q, b, h, H, T, q0);
    load_tile<D>(sdO, dout, b, h, H, T, q0);
    const size_t vec = static_cast<size_t>(bh) * T + qrow;
    const float lse_r = qrow < T ? lse[vec] : 0.0f;
    const float delta_r = qrow < T ? delta[vec] : 0.0f;

    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

    const int nk = k_tiles(qt, T, causal);
    for (int kt = 0; kt < nk; ++kt) {
        __syncthreads();
        load_tile<D>(sK, k, b, hk, Hkv, T, kt * BK);
        load_tile<D>(sV, v, b, hk, Hkv, T, kt * BK);
        __syncthreads();
        {
            FragC s[4];
            gemm_abt<D>(s, sQ + warp * 16 * LD, sK);
            store_scores(sS + warp * 16 * LDS, s);
            gemm_abt<D>(s, sdO + warp * 16 * LD, sV);
            store_scores(sdP + warp * 16 * LDS, s);
        }
        __syncwarp();
        const float* srow = sS + row * LDS;
        const float* dprow = sdP + row * LDS;
        bf16* dsrow = sdS + row * LDP;
        for (int c = half; c < BK; c += 2) {
            const float p = visible(qrow, kt * BK + c, T, causal)
                                ? __expf(srow[c] * scale - lse_r) : 0.0f;
            dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r) * scale);
        }
        __syncwarp();
        gemm_pb<D>(acc, sdS + warp * 16 * LDP, sK);
    }
    __syncthreads();  // the staging tile overlays sS and sdP of every warp
    stage_rows<D>(sS + warp * 16 * Tile<D>::LDF, acc);
    __syncthreads();
    store_tile<D>(dq, sS, b, h, H, T, q0);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                     int Hkv, int causal, float scale) {
    constexpr int LD = Tile<D>::LD;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = sK + 64 * LD;
    bf16* sQ = sV + 64 * LD;
    bf16* sdO = sQ + 64 * LD;
    bf16* sPt = sdO + 64 * LD;
    bf16* sdSt = sPt + 64 * LDP;
    float* sSt = reinterpret_cast<float*>(sdSt + 64 * LDP);
    float* sdPt = sSt + 64 * LDS;
    float* sLse = sdPt + 64 * LDS;
    float* sDelta = sLse + 64;

    const int kt = blockIdx.x;
    const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
    const int k0 = kt * BK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // lanes 2r and 2r+1 share k row r of the warp's 16; columns are q rows
    const int row = warp * 16 + (lane >> 1), half = lane & 1, krow = k0 + row;

    load_tile<D>(sK, k, b, hk, Hkv, T, k0);
    load_tile<D>(sV, v, b, hk, Hkv, T, k0);

    FragC acc_k[D / 16], acc_v[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
        wmma::fill_fragment(acc_k[n], 0.0f);
        wmma::fill_fragment(acc_v[n], 0.0f);
    }

    const int nq = (T + BQ - 1) / BQ;
    const int j0 = causal ? k0 / BQ : 0;  // the TPU kernels' _causal_j0
    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * T;
        const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * T;
        for (int qt = j0; qt < nq; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();
            load_tile<D>(sQ, q, b, h, H, T, q0);
            load_tile<D>(sdO, dout, b, h, H, T, q0);
            if (threadIdx.x < 64) {
                const int t = q0 + threadIdx.x;
                sLse[threadIdx.x] = t < T ? lse_h[t] : 0.0f;
                sDelta[threadIdx.x] = t < T ? delta_h[t] : 0.0f;
            }
            __syncthreads();
            {
                FragC s[4];
                gemm_abt<D>(s, sK + warp * 16 * LD, sQ);    // s^T = k . q^T
                store_scores(sSt + warp * 16 * LDS, s);
                gemm_abt<D>(s, sV + warp * 16 * LD, sdO);   // dp^T = v . do^T
                store_scores(sdPt + warp * 16 * LDS, s);
            }
            __syncwarp();
            const float* srow = sSt + row * LDS;
            const float* dprow = sdPt + row * LDS;
            bf16* prow = sPt + row * LDP;
            bf16* dsrow = sdSt + row * LDP;
            for (int c = half; c < BQ; c += 2) {
                const float p = visible(q0 + c, krow, T, causal)
                                    ? __expf(srow[c] * scale - sLse[c]) : 0.0f;
                prow[c] = __float2bfloat16(p);
                dsrow[c] = __float2bfloat16(p * (dprow[c] - sDelta[c]) * scale);
            }
            __syncwarp();
            gemm_pb<D>(acc_v, sPt + warp * 16 * LDP, sdO);
            gemm_pb<D>(acc_k, sdSt + warp * 16 * LDP, sQ);
        }
    }
    __syncthreads();
    stage_rows<D>(sSt + warp * 16 * Tile<D>::LDF, acc_v);
    __syncthreads();
    store_tile<D>(dv, sSt, b, hk, Hkv, T, k0);
    __syncthreads();
    stage_rows<D>(sSt + warp * 16 * Tile<D>::LDF, acc_k);
    __syncthreads();
    store_tile<D>(dk, sSt, b, hk, Hkv, T, k0);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int T, int H,
              int Hkv, int causal, cudaStream_t stream) {
    constexpr size_t smem = dq_smem<D>();
    if (int e = set_smem(flash_bwd_dq_kernel<D>, smem)) return e;
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), T, H, Hkv, causal, 1.0f / sqrtf(static_cast<float>(D)));
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int H, int Hkv, int causal, cudaStream_t stream) {
    constexpr size_t smem = dkv_smem<D>();
    if (int e = set_smem(flash_bwd_dkv_kernel<D>, smem)) return e;
    const dim3 grid((T + BK - 1) / BK, B * Hkv);
    flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, Hkv, causal,
        1.0f / sqrtf(static_cast<float>(D)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

static bool bad_shape(int B, int T, int H, int Hkv) {
    return B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0;
}

// q, do [B,T,H,D]; k, v [B,T,Hkv,D] bf16; lse, delta [B,H,T] fp32
// -> dq [B,T,H,D] bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int pccl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int T,
                                 int H, int Hkv, int D, int causal, void* stream) {
    if (bad_shape(B, T, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 64)
        return flash::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, T, H, Hkv, causal, s);
    if (D == 128)
        return flash::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, T, H, Hkv, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Same inputs -> dk, dv [B,T,Hkv,D] bf16, summed over the H/Hkv q heads of
// each kv head.
extern "C" int pccl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int T, int H, int Hkv, int D, int causal,
                                  void* stream) {
    if (bad_shape(B, T, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 64)
        return flash::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv,
                                     causal, s);
    if (D == 128)
        return flash::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv,
                                      causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
