// H1: the TPU-native content hash (`simple-tpu`, hash type 2) on Hopper.
//
// Replaces the jitted `_device_planes_fn` of pccl_tpu/ops/hashing.py (used
// by `jax_simplehash_device`); it is not Pallas, but it is the device code
// of shared-state sync. Same function, bit for bit the same as the numpy
// twin `simplehash_tpu` and the C++ pcclt::hash::simplehash_tpu
// (native/src/hash.cpp): the bytes as little-endian u32 words on a
// [rows, 65536] lane grid, the last row zero-padded; per lane
//     a[l] = sum_r w[r, l] * PA^(rows-1-r) + SA * PA^rows   (mod 2^32)
// and the same with PB, SB; then 16 levels of the murmur3-step fold
// h = mix2(lane[i], lane[i + half]), half = 32768 ... 1. Only the two u32
// results (8 bytes) leave the card; the 64-bit finalize runs on the host.
//
// What bounds it on the H100: two multiply-adds per 4 bytes read, so the
// bytes: GPT-2's tok_emb (154.5 MB) takes at least 0.046 ms at 3.35 TB/s.
//
// Design, two launches on the caller's stream:
// - pass 1, `simplehash_tpu_planes`: 512 blocks of 8 warps; a block owns
//   128 lanes, 4 a thread, read as one 16-byte load per row, so a warp
//   reads 512 contiguous bytes of a row. The 8 warps interleave over the
//   rows (warp w takes rows w, w + 8, ...) and run Horner with PA^8; each
//   warp's sum is scaled by PA to the power of the rows after its last
//   one (Horner is linear, so the split is exact mod 2^32), the warps'
//   sums are added in shared memory, and the block writes its lanes with
//   the seed term. Full rows take 16-byte streaming loads, 4 rows in
//   flight a thread; the last row, when ragged, is read byte by byte with
//   zeros past the end. No atomics: the result is deterministic.
// - pass 2, `simplehash_tpu_fold`: one block of 512 threads per call;
//   thread t owns lanes {t + 512 j}. Levels 1-7 pair lanes that differ in
//   bits 15..9, so they stay in the thread: levels 1 and 2 fold at load
//   time (4 loads -> 1 value, 32 values live), levels 3-7 in registers.
//   The last 9 levels run in shared memory. It reads the 512 KB of lanes
//   that pass 1 just wrote, from L2.
// Left for later: spreading the fold over more than one SM, and one launch
// for many entries (a sync hashes 25 at GPT-2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace h1 {

constexpr uint32_t PA = 0x01000193u, SA = 0x811C9DC5u;
constexpr uint32_t PB = 0x85EBCA6Bu, SB = 0x9E3779B9u;
constexpr int LANES = 65536;
constexpr int WARPS = 8;                       // row-interleaved warps
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS = LANES / (32 * 4);       // 128 lanes a block
constexpr int UNROLL = 4;                      // rows in flight a thread
constexpr int FOLD_THREADS = 512;
constexpr int FOLD_J = LANES / FOLD_THREADS;   // 128 lanes a thread

__device__ __forceinline__ uint32_t pow32(uint32_t p, uint64_t e) {
    uint32_t r = 1;
    while (e) {
        if (e & 1) r *= p;
        p *= p;
        e >>= 1;
    }
    return r;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix2(uint32_t h, uint32_t k) {
    k = rotl(k * 0xCC9E2D51u, 15) * 0x1B873593u;
    return rotl(h ^ k, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ void horner(uint32_t (&a)[4], uint32_t (&b)[4],
                                       uint32_t pa, uint32_t pb, uint4 w) {
    a[0] = a[0] * pa + w.x; b[0] = b[0] * pb + w.x;
    a[1] = a[1] * pa + w.y; b[1] = b[1] * pb + w.y;
    a[2] = a[2] * pa + w.z; b[2] = b[2] * pb + w.z;
    a[3] = a[3] * pa + w.w; b[3] = b[3] * pb + w.w;
}

// the four words from word index `word` on, zero past nbytes
__device__ __forceinline__ uint4 load_ragged(const uint8_t *bytes,
                                             uint64_t nbytes, uint64_t word) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint64_t b = (word + k) * 4 + j;
            if (b < nbytes) v |= uint32_t(bytes[b]) << (8 * j);
        }
        w[k] = v;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS)
simplehash_tpu_planes(const uint8_t *__restrict__ data, uint64_t nbytes,
                      uint64_t rows, uint32_t *__restrict__ lanes) {
    __shared__ uint4 part[2][WARPS][32];
    const int warp = threadIdx.x / 32, tl = threadIdx.x % 32;
    const uint32_t l0 = (blockIdx.x * 32 + tl) * 4;   // this thread's lanes
    const uint64_t full_rows = nbytes / (uint64_t(LANES) * 4);
    const uint4 *col = reinterpret_cast<const uint4 *>(data) + l0 / 4;
    constexpr uint64_t ROW = LANES / 4;               // uint4 a row
    const uint32_t pa = pow32(PA, WARPS), pb = pow32(PB, WARPS);

    uint32_t a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
    uint64_t r = warp;
    for (; r + (UNROLL - 1) * WARPS < full_rows; r += UNROLL * WARPS) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            v[u] = __ldcs(col + (r + u * WARPS) * ROW);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) horner(a, b, pa, pb, v[u]);
    }
    for (; r < full_rows; r += WARPS) horner(a, b, pa, pb, __ldcs(col + r * ROW));
    if (r < rows) {  // the ragged last row falls to this warp
        horner(a, b, pa, pb, load_ragged(data, nbytes, r * LANES + l0));
        r += WARPS;
    }
    if (uint64_t(warp) < rows) {
        // r - WARPS is this warp's last row: scale past the rows after it
        const uint64_t after = rows - 1 - (r - WARPS);
        const uint32_t sa = pow32(PA, after), sb = pow32(PB, after);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            a[k] *= sa;
            b[k] *= sb;
        }
    }
    part[0][warp][tl] = make_uint4(a[0], a[1], a[2], a[3]);
    part[1][warp][tl] = make_uint4(b[0], b[1], b[2], b[3]);
    __syncthreads();
    if (warp < 2) {  // warp 0 sums plane A, warp 1 plane B
        const uint32_t seed = warp == 0 ? SA * pow32(PA, rows)
                                        : SB * pow32(PB, rows);
        uint4 s = make_uint4(seed, seed, seed, seed);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const uint4 p = part[warp][w][tl];
            s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
        }
        reinterpret_cast<uint4 *>(lanes + warp * LANES)[l0 / 4] = s;
    }
}

// levels of the fold within a thread: v[j] = mix2(v[j], v[j + H]), H
// halving to 1 (a template, so that every index is a constant and v stays
// in registers)
template <int H, int N>
__device__ __forceinline__ void fold_regs(uint32_t (&v)[N]) {
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] = mix2(v[j], v[j + H]);
    if constexpr (H > 1) fold_regs<H / 2>(v);
}

__global__ void __launch_bounds__(FOLD_THREADS)
simplehash_tpu_fold(const uint32_t *__restrict__ lanes,
                    unsigned long long *__restrict__ out) {
    __shared__ uint32_t s[FOLD_THREADS];
    const int t = threadIdx.x;
    for (int plane = 0; plane < 2; ++plane) {
        const uint32_t *L = lanes + plane * LANES + t;
        constexpr int Q = FOLD_J / 4;  // 32 values after levels 1 and 2
        uint32_t v[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
            const int J = FOLD_THREADS;
            v[j] = mix2(mix2(L[J * j], L[J * (j + 2 * Q)]),
                        mix2(L[J * (j + Q)], L[J * (j + 3 * Q)]));
        }
        fold_regs<Q / 2>(v);
        s[t] = v[0];
        __syncthreads();
        for (int h = FOLD_THREADS / 2; h >= 1; h /= 2) {
            if (t < h) s[t] = mix2(s[t], s[t + h]);
            __syncthreads();
        }
        if (t == 0) out[plane] = s[0];
        __syncthreads();
    }
}

}  // namespace h1

// data: 16-byte aligned, nbytes > 0; lanes: 2 * 65536 u32 of scratch; out:
// two u64 (the folded planes A and B). Returns the launch's cudaError_t.
extern "C" int pccl_simplehash_tpu(const void *data, uint64_t nbytes,
                                   void *lanes, void *out, void *stream) {
    if (nbytes == 0 || reinterpret_cast<uintptr_t>(data) % 16)
        return cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    const uint64_t rows = ((nbytes + 3) / 4 + h1::LANES - 1) / h1::LANES;
    h1::simplehash_tpu_planes<<<h1::BLOCKS, h1::THREADS, 0, s>>>(
        static_cast<const uint8_t *>(data), nbytes, rows,
        static_cast<uint32_t *>(lanes));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    h1::simplehash_tpu_fold<<<1, h1::FOLD_THREADS, 0, s>>>(
        static_cast<const uint32_t *>(lanes),
        static_cast<unsigned long long *>(out));
    return cudaGetLastError();
}
