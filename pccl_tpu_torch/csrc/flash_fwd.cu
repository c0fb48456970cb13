// Flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// pccl_tpu/ops/flash_attention.py (reached through `_flash_bhtd`'s
// pl.pallas_call). Same function: online softmax over k tiles with a running
// max m, normalizer l and an fp32 accumulator; o = acc / l, lse = m + log l;
// scores masked with -1e30; P cast to bf16 before P.V.
//
// What bounds it on the H100: at the main path's shape (B=8, T=1024, H=12,
// Dh=64, causal) it must move 50.7 MB (q, k, v read once, o and lse written
// once), 0.0151 ms at 3.35 TB/s, against 12.9 GFLOP of products, 0.0130 ms
// at 989 TFLOP/s: bound by bytes, barely. Both are far below what a block
// loop of products and softmax reaches, so the design aims at keeping the
// tensor cores fed.
//
// Design (warp-specialised, one block per (batch*head, q tile of 128 rows),
// longest causal rows first):
// - a producer warpgroup, cut to 24 registers by setmaxnreg, of which one
//   thread works: it TMA-loads the q tile once, then walks the k tiles (BK
//   = 128 rows) the causal bound lets the q tile see (the TPU kernel's
//   _causal_nk), loading K and V into a ring of 2 stages, each with its own
//   "full" mbarrier so that Q.K^T starts before V lands;
// - two consumer warpgroups (setmaxnreg 240), each owning 64 q rows (the M
//   of one wgmma). Per k tile: S = Q.K^T by wgmma from shared memory (both
//   K-major), the -1e30 mask on the diagonal and ragged tiles only (TMA
//   reads rows past T as zeros, which would score 0), the online softmax in
//   registers (row max and sum over the 4 threads that share a row; exp2
//   with log2(e) folded into the scale, lse still in natural log), P
//   rounded to bf16 in registers as the A operand of O += P.V (V MN-major),
//   O rescaled in registers. The two warpgroups' products and softmax
//   interleave on the SM. (Issuing tile j's S before tile j-1's P.V, so
//   that a warpgroup's softmax overlaps its own product, was tried and was
//   no faster at chip_smoke.py's shapes.)
// - epilogue: o = acc / l through registers -> bf16 -> shared memory ->
//   16-byte stores, rows past T skipped; lse to [B, H, T].
// Nothing crosses blocks and there are no atomics, so results are
// deterministic. Left for later: ordering the two warpgroups' softmax
// against each other's wgmma (ping-pong), and a persistent grid.
//
// Head dims 16 and 32 (the `nano` and `tiny` presets) run the Dh = 64
// instantiation at a padded width (hopper.cuh): TMA reads the columns past
// the true head dim d as zeros, the products run at depth and width 64 (4x
// and 2x the operations of the bound), and the epilogue stores d columns.
// The scale is 1/sqrt(d) of the true d.
#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int FWD_BQ = 128;       // q rows per block, 64 per consumer
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 384;  // producer warpgroup + 2 consumers
constexpr float MASK = -1e30f;    // the TPU kernels' mask fill

template <int D>
struct FwdSmem {
    static constexpr int BK = 128;                     // k rows per tile
    static constexpr int Q_BYTES = FWD_BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int O_ELEMS = 64 * (D + 8);       // one consumer's staging
    static constexpr int OFF_K = Q_BYTES;              // every tile 1024-aligned
    static constexpr int OFF_V = OFF_K + FWD_STAGES * KV_BYTES;
    static constexpr int OFF_O = OFF_V + FWD_STAGES * KV_BYTES;
    static constexpr int OFF_BAR = OFF_O + 2 * O_ELEMS * 2;
    static constexpr int BYTES = OFF_BAR + (1 + 3 * FWD_STAGES) * 8 + 1024;
};

// One tile's online-softmax step, in place, for a consumer thread's rows ra
// and ra + 8: the -1e30 mask (on the diagonal and ragged tiles only), the
// new running max m (row max over the 4 threads that share a row), s
// becomes p = exp(s - m) with log2(e) folded into sl2, corr the factor that
// rescales the old sums and O, and l the thread's partial row sums (corr is
// the same on the 4 threads of a row, so they are added up at the end).
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, int ra, int lane,
                                             int T, int causal, float sl2) {
    if ((causal && k0 + BK - 1 > row0) || k0 + BK > T) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            const int row = ra + 8 * ((i / 2) % 2);
            if (col >= T || (causal && col > row)) s[i] = MASK;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        neg[r] = -mx[r] * sl2;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        s[i] = ex2(fmaf(s[i], sl2, neg[(i / 2) % 2]));
        rs[(i / 2) % 2] += s[i];
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int Hkv, int d,
                 int causal, float scale) {
    using L = FwdSmem<D>;
    constexpr int BQ = FWD_BQ, BK = L::BK;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = reinterpret_cast<bf16*>(smem + L::OFF_K);
    bf16* sV = reinterpret_cast<bf16*>(smem + L::OFF_V);
    bf16* sO = reinterpret_cast<bf16*>(smem + L::OFF_O);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + FWD_STAGES;
    uint64_t* kv_empty = v_full + FWD_STAGES;

    const int nq = (T + BQ - 1) / BQ;
    const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int nkt = (T + BK - 1) / BK;
    const int nk = causal ? min(nkt, (q0 + BQ + BK - 1) / BK) : nkt;
    // warp-uniform for the compiler too, as the role split needs
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < FWD_STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&kv_empty[s], 256);  // every consumer thread
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == 0) {
        // ---- producer
        reg_dealloc<24>();
        if (threadIdx.x == 0) {
            prefetch_map(&tm_q);
            prefetch_map(&tm_k);
            prefetch_map(&tm_v);
            mbar_expect_tx(q_full, L::Q_BYTES);
            tma_load_rows<D, BQ>(sQ, &tm_q, q_full, b, h, q0);
            Ring<FWD_STAGES> ring;
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
        // ---- consumers: c owns q rows [q0 + 64c, q0 + 64c + 64)
        reg_alloc<240>();
        const int c = wg - 1;
        const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
        const int row0 = q0 + 64 * c;
        const int ra = row0 + 16 * w + lane / 4;  // this thread's rows: ra, ra + 8
        const float sl2 = scale * 1.4426950408889634f;
        float m[2] = {MASK, MASK}, l[2] = {0.0f, 0.0f}, corr[2];
        float acc[D / 2], s[BK / 2];
        uint32_t p[BK / 16][4];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;

        mbar_wait(q_full, 0);
        Ring<FWD_STAGES> ring;
        for (int kt = 0; kt < nk; ++kt) {
            const int st = ring.stage;
            mbar_wait(&k_full[st], ring.phase);
            const uint64_t dq = desc_kmajor(sQ, 64 * c);
            const uint64_t dk = desc_kmajor(sK + st * BK * D, 0);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<0, 0>(s, kmajor_step<BQ>(dq, kk), kmajor_step<BK>(dk, kk), kk > 0);
            wg_commit();
            wg_wait<0>();
            fence_regs(s);

            softmax_step<BK>(s, m, l, corr, kt * BK, row0, ra, lane, T, causal, sl2);
            pack_a<BK>(p, s);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

            mbar_wait(&v_full[st], ring.phase);
            const uint64_t dv = desc_mnmajor<BK>(sV + st * BK * D);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs<1>(acc, p[kk], mnmajor_step(dv, kk), 1);
            wg_commit();
            wg_wait<0>();
            fence_regs(acc);
            fence_regs(p);
            mbar_arrive(&kv_empty[st]);
            ring.next();
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        if (lane % 4 == 0) {
            float* lse_bh = lse + static_cast<size_t>(bh) * T;
            if (ra < T) lse_bh[ra] = m[0] * scale + logf(l[0]);
            if (ra + 8 < T) lse_bh[ra + 8] = m[1] * scale + logf(l[1]);
        }
        store_rows<D>(acc, 1.0f / l[0], 1.0f / l[1], sO + c * L::O_ELEMS,
                      o + (static_cast<size_t>(b) * T * H + h) * d,
                      static_cast<size_t>(H) * d, row0, T, d, 1 + c);
    }
}

// D: the width computed at (64 or 128); d: the tensors' head dim, d <= D.
template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int T, int H, int Hkv, int d, int causal, cudaStream_t stream) {
    constexpr size_t smem = FwdSmem<D>::BYTES;
    if (int e = allow_smem<flash_fwd_kernel<D>>(smem)) return e;
    CUtensorMap tq, tk, tv;
    if (int e = make_map(&tq, q, B, T, H, d, FWD_BQ)) return e;
    if (int e = make_map(&tk, k, B, T, Hkv, d, FwdSmem<D>::BK)) return e;
    if (int e = make_map(&tv, v, B, T, Hkv, d, FwdSmem<D>::BK)) return e;
    const dim3 grid((T + FWD_BQ - 1) / FWD_BQ, B * H);
    flash_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), T, H, Hkv, d,
        causal, 1.0f / sqrtf(static_cast<float>(d)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q [B,T,H,D], k/v [B,T,Hkv,D] bf16 -> o [B,T,H,D] bf16, lse [B,H,T] fp32.
// Every pointer 16-byte aligned. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int pccl_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int Hkv,
                              int D, int causal, void* stream) {
    if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 16 || D == 32 || D == 64)
        return flash::launch_fwd<64>(q, k, v, o, lse, B, T, H, Hkv, D, causal, s);
    if (D == 128)
        return flash::launch_fwd<128>(q, k, v, o, lse, B, T, H, Hkv, D, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
