// Flash-attention backward dq for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` of
// pccl_tpu/ops/flash_attention.py (the first pl.pallas_call of
// `_flash_bwd_bhtd`; K3, its second, is csrc/flash_bwd_dkv.cu). Same
// function: with p = exp(s - lse) rebuilt from the forward's log-sum-exp and
// delta = rowsum(do * o) (computed by the caller in fp32, minus dlse when
// the lse has a cotangent),
//     ds = p * (do . v^T - delta) * scale, cast to bf16,   dq = sum_k ds . k,
// with fp32 accumulation and the -1e30 mask of the forward.
//
// What bounds it on the H100: at the main path's shape (B=8, T=1024, H=12,
// Dh=64, causal) its three products are 19.3 GFLOP, 0.0196 ms at 989
// TFLOP/s, against 63.7 MB read once and written once, 0.0190 ms at 3.35
// TB/s: bound by operations, barely.
//
// Design (warp-specialised, one block per (batch*head, q tile of 64 rows),
// longest causal rows first, 160 threads):
// - one producer warp. Its lane 0 TMA-loads the q and do tiles once, then
//   walks the k tiles (BK = 64 rows) the causal bound lets the q tile see
//   (the TPU kernel's _causal_nk), loading K and V into a ring of 2 stages,
//   each with its own "full" mbarrier so that S = Q.K^T starts before V
//   lands;
// - one consumer warpgroup owning the 64 q rows, with each thread's rows'
//   lse (times log2 e) and delta in registers. Per k tile: S = Q.K^T and
//   dP = dO.V^T by wgmma from shared memory (all K-major); p = exp2(s *
//   scale * log2 e - lse2) while dP is still in flight, masked on the
//   diagonal and ragged tiles only (TMA reads k rows past T as zeros, which
//   would score 0); dS = p * (dP - delta) * scale rounded to bf16 in
//   registers as the A operand of dQ += dS.K (K MN-major). dQ stays in
//   registers for the whole block and is written once, so there are no
//   atomics and results are deterministic;
// - epilogue: dQ through shared memory (over the q and do tiles, which no
//   product reads any more), 16-byte stores, rows past T skipped.
// One consumer over 64 q rows rather than two over 128, and BK = 64 at both
// head dims: the faster form at every shape chip_smoke.py measures, with
// up to three blocks an SM (PERF.md, section 6).
//
// Head dims 16 and 32 run the Dh = 64 instantiation at a padded width
// (hopper.cuh): the q, do, k and v tiles' columns past the true d read as
// zeros, so S, dP and dQ's first d columns are exact, and only d columns
// of dQ are stored; the scale is 1/sqrt(d). DqCfg<64> is the layout they
// use, so its static_assert (the dQ staging fits over the q and do
// tiles) is the one that holds for them.
#include "hopper.cuh"

namespace flash {

using namespace hopper;

template <int D>
struct DqCfg {
    static constexpr int BQ = 64;                      // q rows per block
    static constexpr int BK = 64;                      // k rows per tile
    static constexpr int STAGES = 2;
    static constexpr int THREADS = 128 + 32;           // consumer + producer warp
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int ST_ELEMS = 64 * (D + 8);      // the consumer's staging
    static constexpr int OFF_DO = Q_BYTES;             // every tile 1024-aligned
    static constexpr int OFF_K = 2 * Q_BYTES;
    static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
    static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
    static constexpr int BYTES = OFF_BAR + (1 + 3 * STAGES) * 8 + 1024;
    static_assert(ST_ELEMS * 2 <= 2 * Q_BYTES, "staging overlays the q and do tiles");
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int H, int Hkv, int d,
                    int causal, float scale) {
    using L = DqCfg<D>;
    constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sdO = reinterpret_cast<bf16*>(smem + L::OFF_DO);
    bf16* sK = reinterpret_cast<bf16*>(smem + L::OFF_K);
    bf16* sV = reinterpret_cast<bf16*>(smem + L::OFF_V);
    uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
    uint64_t* k_full = qdo_full + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* kv_empty = v_full + STAGES;

    const int nq = (T + BQ - 1) / BQ;
    const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int nkt = (T + BK - 1) / BK;
    const int nk = causal ? min(nkt, (q0 + BQ + BK - 1) / BK) : nkt;
    // warp-uniform for the compiler too, as the role split needs
    const bool producer = __shfl_sync(0xffffffffu, threadIdx.x >= 128, 0);

    if (threadIdx.x == 0) {
        mbar_init(qdo_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&kv_empty[s], 128);  // every consumer thread
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (producer) {
        // ---- producer warp
        if (threadIdx.x == 128) {
            prefetch_map(&tm_q);
            prefetch_map(&tm_k);
            prefetch_map(&tm_v);
            prefetch_map(&tm_do);
            mbar_expect_tx(qdo_full, 2 * L::Q_BYTES);
            tma_load_rows<D, BQ>(sQ, &tm_q, qdo_full, b, h, q0);
            tma_load_rows<D, BQ>(sdO, &tm_do, qdo_full, b, h, q0);
            Ring<STAGES> ring;
            for (int kt = 0; kt < nk; ++kt) {
                const int s = ring.stage;
                mbar_wait(&kv_empty[s], ring.phase ^ 1u);
                mbar_expect_tx(&k_full[s], L::KV_BYTES);
                tma_load_rows<D, BK>(sK + s * BK * D, &tm_k, &k_full[s], b, hk, kt * BK);
                mbar_expect_tx(&v_full[s], L::KV_BYTES);
                tma_load_rows<D, BK>(sV + s * BK * D, &tm_v, &v_full[s], b, hk, kt * BK);
                ring.next();
            }
        }
    } else {
        // ---- consumer warpgroup: q rows [q0, q0 + 64)
        const int t = threadIdx.x, w = t / 32, lane = t % 32;
        const int ra = q0 + 16 * w + lane / 4;  // this thread's q rows: ra, ra + 8
        const float sl2 = scale * 1.4426950408889634f;
        float lse2[2], dlt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = ra + 8 * r;
            const size_t at = static_cast<size_t>(bh) * T + row;
            lse2[r] = row < T ? lse[at] * 1.4426950408889634f : 0.0f;
            dlt[r] = row < T ? delta[at] : 0.0f;
        }
        float acc[D / 2], s[BK / 2], dp[BK / 2];
        uint32_t dsa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;

        mbar_wait(qdo_full, 0);
        Ring<STAGES> ring;
        for (int kt = 0; kt < nk; ++kt) {
            const int st = ring.stage;
            const bf16* k_tile = sK + st * BK * D;
            const bf16* v_tile = sV + st * BK * D;
            mbar_wait(&k_full[st], ring.phase);
            const uint64_t dqd = desc_kmajor(sQ, 0);
            const uint64_t dkd = desc_kmajor(k_tile, 0);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<0, 0>(s, kmajor_step<BQ>(dqd, kk), kmajor_step<BK>(dkd, kk), kk > 0);
            wg_commit();
            mbar_wait(&v_full[st], ring.phase);
            const uint64_t dod = desc_kmajor(sdO, 0);
            const uint64_t dvd = desc_kmajor(v_tile, 0);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<0, 0>(dp, kmajor_step<BQ>(dod, kk), kmajor_step<BK>(dvd, kk), kk > 0);
            wg_commit();
            wg_wait<1>();  // S is done; dP may still run
            fence_regs(s);

            const int k0 = kt * BK;
            const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > T;
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
                const int row = ra + 8 * ((i / 2) % 2);
                float p = ex2(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
                if (edge && (col >= T || (causal && col > row))) p = 0.0f;
                s[i] = p;
            }
            wg_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
                dp[i] = s[i] * (dp[i] - dlt[(i / 2) % 2]) * scale;
            pack_a<BK>(dsa, dp);

            const uint64_t dkm = desc_mnmajor<BK>(k_tile);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs<1>(acc, dsa[kk], mnmajor_step(dkm, kk), 1);
            wg_commit();
            wg_wait<0>();
            fence_regs(acc);
            fence_regs(dsa);
            mbar_arrive(&kv_empty[st]);
            ring.next();
        }

        wg_bar(1);  // every warp's products have read the q and do tiles
        store_rows<D>(acc, 1.0f, 1.0f, sQ, dq + (static_cast<size_t>(b) * T * H + h) * d,
                      static_cast<size_t>(H) * d, q0, T, d, 1);
    }
}

// D: the width computed at (64 or 128); d: the tensors' head dim, d <= D.
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int T, int H,
              int Hkv, int d, int causal, cudaStream_t stream) {
    using L = DqCfg<D>;
    if (int e = allow_smem<flash_bwd_dq_kernel<D>>(L::BYTES)) return e;
    CUtensorMap tq, tk, tv, tdo;
    if (int e = make_map(&tq, q, B, T, H, d, L::BQ)) return e;
    if (int e = make_map(&tk, k, B, T, Hkv, d, L::BK)) return e;
    if (int e = make_map(&tv, v, B, T, Hkv, d, L::BK)) return e;
    if (int e = make_map(&tdo, dout, B, T, H, d, L::BQ)) return e;
    const dim3 grid((T + L::BQ - 1) / L::BQ, B * H);
    flash_bwd_dq_kernel<D><<<grid, L::THREADS, L::BYTES, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), T, H, Hkv, d, causal, 1.0f / sqrtf(static_cast<float>(d)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q, do [B,T,H,D]; k, v [B,T,Hkv,D] bf16; lse, delta [B,H,T] fp32
// -> dq [B,T,H,D] bf16. Every pointer 16-byte aligned. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int pccl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int T,
                                 int H, int Hkv, int D, int causal, void* stream) {
    if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 16 || D == 32 || D == 64)
        return flash::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, T, H, Hkv, D,
                                    causal, s);
    if (D == 128)
        return flash::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, T, H, Hkv, D,
                                     causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
