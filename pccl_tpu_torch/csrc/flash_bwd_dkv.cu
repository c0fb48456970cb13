// Flash-attention backward dK/dV for Hopper (sm_90a): K3.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` of
// pccl_tpu/ops/flash_attention.py (the second pl.pallas_call of
// `_flash_bwd_bhtd`). Same function: with p = exp(s - lse) rebuilt from the
// forward's log-sum-exp and delta = rowsum(do * o) (computed by the caller
// in fp32, minus dlse when the lse has a cotangent),
//     ds = p * (do . v^T - delta) * scale,
//     dv = sum_q p^T . do,   dk = sum_q ds^T . q,
// summed over the G = H / Hkv q heads of each kv head, with p and ds cast
// to bf16 before the second products, fp32 accumulation and the -1e30 mask
// of the forward.
//
// What bounds it on the H100: at the main path's shape (B=8, T=1024, H=12,
// Dh=64, causal) its four products are 25.8 GFLOP, 0.0261 ms at 989
// TFLOP/s, against 76.3 MB read once and written once, 0.0228 ms at 3.35
// TB/s: bound by operations.
//
// Design (warp-specialised, one block per (batch*kv head, k tile of 64
// rows), the tiles with the most causal work first, 160 threads):
// - one producer warp. Its lane 0 TMA-loads the K and V tile once, then
//   walks every (g, q tile) pair the TPU kernel walks (g in [0, G), q tiles
//   from _causal_j0), loading the q and do tiles into a ring (BQ = 64 rows
//   and 2 stages at Dh = 64, 32 rows and 4 stages at Dh = 128, see
//   DkvCfg); all 32 lanes copy that tile's lse (times log2 e) and delta
//   into the same stage. The producer and the consumers derive the walk
//   from `DkvWalk`: under causality the trip count depends on the k tile,
//   and a mismatch would deadlock on a barrier phase.
// - one consumer warpgroup owning the 64 k rows; dK and dV stay in
//   registers for the whole block (64 + 64 fp32 a thread at Dh = 128) and
//   are written once, so there are no atomics and results are
//   deterministic. Per stage: S^T = K.Q^T and dP^T = V.dO^T by wgmma from
//   shared memory (all K-major); P^T and dS^T in registers, masked on the
//   diagonal and ragged tiles only; dV += P^T.dO and dK += dS^T.Q with P^T
//   and dS^T as bf16 register A operands and dO, Q MN-major.
// - epilogue: dK and dV through shared memory, 16-byte stores, rows past T
//   skipped.
// One consumer warpgroup rather than two over 128 k rows: the two-consumer
// form spilled at Dh = 128 and was slower at every shape chip_smoke.py
// measures (PERF.md, section 6, PR 2).
//
// Head dims 16 and 32 run the Dh = 64 instantiation at a padded width
// (hopper.cuh): the tiles' columns past the true d read as zeros, so S^T,
// dP^T and the first d columns of dK and dV are exact, and only d columns
// are stored; the scale is 1/sqrt(d). They take DkvCfg<64>'s BQ = 64 and
// 2 stages, whose registers (32 + 32 fp32 of dK and dV a thread) and ring
// bytes are the Dh = 64 kernel's.
#include "hopper.cuh"

namespace flash {

using namespace hopper;

// One consumer warpgroup (64 k rows a block) and one producer warp. q rows
// per stage and stages of the ring: at Dh = 128, dK and dV take 128
// registers a thread, so S^T and dP^T get a 32-row q tile, with twice the
// stages to keep the ring's bytes.
template <int D>
struct DkvCfg {
    static constexpr int BK = 64;
    static constexpr int THREADS = 128 + 32;
    static constexpr int BQ = D == 128 ? 32 : 64;
    static constexpr int STAGES = D == 128 ? 4 : 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int ST_ELEMS = 64 * (D + 8);     // the consumer's staging
    static constexpr int OFF_V = KV_BYTES;            // every tile 1024-aligned
    static constexpr int OFF_Q = 2 * KV_BYTES;
    static constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
    static constexpr int OFF_VEC = OFF_DO + STAGES * Q_BYTES;  // lse2, delta
    static constexpr int OFF_ST = OFF_VEC + STAGES * 2 * BQ * 4;
    static constexpr int OFF_BAR = OFF_ST + ST_ELEMS * 2;
    static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES) * 8 + 1024;
};

// The (g, q tile) pairs block kt walks, in order; one definition for the
// producer and the consumers.
template <int BK, int BQ>
struct DkvWalk {
    int j0, nq;
    __device__ DkvWalk(int kt, int T, int causal)
        : j0(causal ? kt * BK / BQ : 0), nq((T + BQ - 1) / BQ) {}
    __device__ int count(int G) const { return G * (nq - j0); }
    __device__ void at(int step, int& g, int& qt) const {
        g = step / (nq - j0);
        qt = j0 + step % (nq - j0);
    }
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                     int Hkv, int d, int causal, float scale) {
    using L = DkvCfg<D>;
    constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = reinterpret_cast<bf16*>(smem + L::OFF_V);
    bf16* sQ = reinterpret_cast<bf16*>(smem + L::OFF_Q);
    bf16* sdO = reinterpret_cast<bf16*>(smem + L::OFF_DO);
    float* sVec = reinterpret_cast<float*>(smem + L::OFF_VEC);
    bf16* sSt = reinterpret_cast<bf16*>(smem + L::OFF_ST);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + STAGES;

    const int kt = blockIdx.x;
    const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
    const int k0 = kt * BK;
    const DkvWalk<BK, BQ> walk(kt, T, causal);
    const int steps = walk.count(G);
    // warp-uniform for the compiler too, as the role split needs
    const bool producer = __shfl_sync(0xffffffffu, threadIdx.x >= 128, 0);

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1 + 32);     // lane 0's expect_tx + every lane
            mbar_init(&empty[s], 128);       // every consumer thread
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (producer) {
        // ---- producer warp
        const int lane = threadIdx.x % 32;
        if (lane == 0) {
            prefetch_map(&tm_q);
            prefetch_map(&tm_k);
            prefetch_map(&tm_v);
            prefetch_map(&tm_do);
            mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
            tma_load_rows<D, BK>(sK, &tm_k, kv_full, b, hk, k0);
            tma_load_rows<D, BK>(sV, &tm_v, kv_full, b, hk, k0);
        }
        Ring<STAGES> ring;
        for (int i = 0; i < steps; ++i) {
            int g, qt;
            walk.at(i, g, qt);
            const int s = ring.stage, h = hk * G + g;
            mbar_wait(&empty[s], ring.phase ^ 1u);
            if (lane == 0) {
                mbar_expect_tx(&full[s], 2 * L::Q_BYTES);
                tma_load_rows<D, BQ>(sQ + s * BQ * D, &tm_q, &full[s], b, h, qt * BQ);
                tma_load_rows<D, BQ>(sdO + s * BQ * D, &tm_do, &full[s], b, h, qt * BQ);
            }
            const size_t base = (static_cast<size_t>(b) * H + h) * T;
            float* vec = sVec + s * 2 * BQ;
            for (int j = lane; j < BQ; j += 32) {
                const int t = qt * BQ + j;
                vec[j] = t < T ? lse[base + t] * 1.4426950408889634f : 0.0f;
                vec[BQ + j] = t < T ? delta[base + t] : 0.0f;
            }
            mbar_arrive(&full[s]);
            ring.next();
        }
    } else {
        // ---- consumer warpgroup: k rows [k0, k0 + 64)
        const int t = threadIdx.x, w = t / 32, lane = t % 32;
        const int row0 = k0;
        const int ra = row0 + 16 * w + lane / 4;  // this thread's k rows: ra, ra + 8
        const float sl2 = scale * 1.4426950408889634f;
        float acc_v[D / 2], acc_k[D / 2], st[BQ / 2], dpt[BQ / 2];
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc_v[i] = acc_k[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;

        mbar_wait(kv_full, 0);
        Ring<STAGES> ring;
        for (int i = 0; i < steps; ++i) {
            int g, qt;
            walk.at(i, g, qt);
            const int q0 = qt * BQ;
            const int s = ring.stage;
            const bf16* q_tile = sQ + s * BQ * D;
            const bf16* do_tile = sdO + s * BQ * D;
            const float* vec = sVec + s * 2 * BQ;
            mbar_wait(&full[s], ring.phase);
            const uint64_t dk_ = desc_kmajor(sK, 0);
            const uint64_t dv_ = desc_kmajor(sV, 0);
            const uint64_t dq_ = desc_kmajor(q_tile, 0);
            const uint64_t ddo = desc_kmajor(do_tile, 0);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<0, 0>(st, kmajor_step<BK>(dk_, kk), kmajor_step<BQ>(dq_, kk), kk > 0);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<0, 0>(dpt, kmajor_step<BK>(dv_, kk), kmajor_step<BQ>(ddo, kk), kk > 0);
            wg_commit();
            wg_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            const bool edge = (causal && q0 < row0 + 63) || q0 + BQ > T || row0 + 64 > T;
#pragma unroll
            for (int j = 0; j < BQ / 2; ++j) {
                const int col = 8 * (j / 4) + 2 * (lane % 4) + (j % 2);  // q row in the tile
                const int row = ra + 8 * ((j / 2) % 2);
                float p = ex2(fmaf(st[j], sl2, -vec[col]));
                if (edge && (q0 + col >= T || row >= T || (causal && row > q0 + col)))
                    p = 0.0f;
                dpt[j] = p * (dpt[j] - vec[BQ + col]) * scale;
                st[j] = p;
            }
            pack_a<BQ>(pa, st);
            pack_a<BQ>(dsa, dpt);

            const uint64_t mdo = desc_mnmajor<BQ>(do_tile);
            const uint64_t mq = desc_mnmajor<BQ>(q_tile);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                wgmma_rs<1>(acc_v, pa[kk], mnmajor_step(mdo, kk), 1);
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                wgmma_rs<1>(acc_k, dsa[kk], mnmajor_step(mq, kk), 1);
            wg_commit();
            wg_wait<0>();
            fence_regs(acc_v);
            fence_regs(acc_k);
            fence_regs(pa);
            fence_regs(dsa);
            mbar_arrive(&empty[s]);
            ring.next();
        }

        const size_t off = (static_cast<size_t>(b) * T * Hkv + hk) * d;
        const size_t stride = static_cast<size_t>(Hkv) * d;
        store_rows<D>(acc_v, 1.0f, 1.0f, sSt, dv + off, stride, row0, T, d, 1);
        store_rows<D>(acc_k, 1.0f, 1.0f, sSt, dk + off, stride, row0, T, d, 1);
    }
}

// D: the width computed at (64 or 128); d: the tensors' head dim, d <= D.
template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int H, int Hkv, int d, int causal, cudaStream_t stream) {
    using L = DkvCfg<D>;
    if (int e = allow_smem<flash_bwd_dkv_kernel<D>>(L::BYTES)) return e;
    CUtensorMap tq, tk, tv, tdo;
    if (int e = make_map(&tq, q, B, T, H, d, L::BQ)) return e;
    if (int e = make_map(&tk, k, B, T, Hkv, d, L::BK)) return e;
    if (int e = make_map(&tv, v, B, T, Hkv, d, L::BK)) return e;
    if (int e = make_map(&tdo, dout, B, T, H, d, L::BQ)) return e;
    const dim3 grid((T + L::BK - 1) / L::BK, B * Hkv);
    flash_bwd_dkv_kernel<D><<<grid, L::THREADS, L::BYTES, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), T, H, Hkv, d, causal,
        1.0f / sqrtf(static_cast<float>(d)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q, do [B,T,H,D]; k, v [B,T,Hkv,D] bf16; lse, delta [B,H,T] fp32
// -> dk, dv [B,T,Hkv,D] bf16, summed over the H/Hkv q heads of each kv head.
// Every pointer 16-byte aligned. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int pccl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int T, int H, int Hkv, int D, int causal,
                                  void* stream) {
    if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 16 || D == 32 || D == 64)
        return flash::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv,
                                     D, causal, s);
    if (D == 128)
        return flash::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv,
                                      D, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
