"""Content hashing of shared-state entries: the numpy twins of the native
hashes, and H1, the TPU-native hash (hash type 2, `simple-tpu`) computed on
the card.

The numpy twins (`simplehash`, `simplehash_tpu`) are this package's own
copies of pccl_tpu/ops/hashing.py's; both are bit-identical to the C++ core
(`pccltHashBuffer`, native/src/hash.cpp).

`simple-tpu` over a byte string: the bytes read as little-endian u32 words,
word i at (row i // 65536, lane i % 65536) of a [rows, 65536] grid whose
last row is zero-padded; per lane two u32 Horner planes,
    lane_a[l] = sum_r w[r, l] * PA^(rows-1-r) + SA * PA^rows  (mod 2^32),
and the same with PB, SB; then 16 levels of the murmur3-step fold `_mix2`,
halving the lanes, to one u32 per plane; on the host, the two u32 as one
u64, XOR the Q-scaled byte length, avalanche.

H1 (`csrc/simplehash_tpu.cu`) computes the planes and the fold on the card,
so only 8 bytes cross to the host: a clean shared-state sync of GPT-2's
1.48 GB of parameters and AdamW state reads 8 bytes per entry instead of
staging the state. It replaces the jitted `_device_planes_fn` of
pccl_tpu/ops/hashing.py. `device_planes` launches it for a CUDA tensor and
takes the plain version `planes_plain` only for a tensor on the CPU.

The word stream is the tensor's raw bytes, whatever the dtype: for 1-, 2-
and 4-byte dtypes it is the JAX package's `_words_u32`, and 8-byte dtypes
hash on the card too (the JAX package hashes those on the host).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# ------------------------------------------------------------ numpy twins

LANES = 256
P = np.uint64(0x100000001B3)          # FNV-1a prime
Q = np.uint64(0x9E3779B97F4A7C15)     # 2^64 / phi
SEED = np.uint64(0xCBF29CE484222325)  # FNV offset basis
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)

_BLOCK = 4096  # full rows folded per vectorized step


def _p_powers(n: int) -> np.ndarray:
    """P^0..P^n with uint64 wraparound."""
    with np.errstate(over="ignore"):
        pows = np.empty(n + 1, dtype=np.uint64)
        pows[0] = np.uint64(1)
        for i in range(1, n + 1):
            pows[i] = pows[i - 1] * P
    return pows


_P_POWS = _p_powers(_BLOCK)


def _avalanche64(x: np.uint64) -> np.uint64:
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= _M1
        x ^= x >> np.uint64(33)
        x *= _M2
        x ^= x >> np.uint64(33)
    return x


def _as_bytes(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.frombuffer(memoryview(buf), dtype=np.uint8)


def simplehash(buf) -> int:
    """Hash type 0 of a bytes-like or ndarray's raw content (256 lanes,
    64-bit Horner). Bit-identical to the native pcclt::hash::simplehash."""
    data = _as_bytes(buf)
    nbytes = data.size
    n_words = (nbytes + 3) // 4
    padded = np.zeros(((n_words + LANES - 1) // LANES) * LANES * 4,
                      dtype=np.uint8)
    padded[:nbytes] = data
    words = padded.view("<u4").astype(np.uint64).reshape(-1, LANES)

    # lane[l] = Horner over its word column, full rows folded in blocks of
    # B: lane = lane * P^B + sum words[r] * P^(B-1-r)
    lane = np.full(LANES, SEED, dtype=np.uint64)
    n_rows = n_words // LANES
    with np.errstate(over="ignore"):
        r = 0
        while r < n_rows:
            b = min(_BLOCK, n_rows - r)
            weights = _P_POWS[b - 1::-1][:, None]      # P^(b-1) ... P^0
            lane = lane * _P_POWS[b] + (words[r:r + b] * weights).sum(
                axis=0, dtype=np.uint64)
            r += b
        if n_rows * LANES != n_words:  # partial last row
            k = n_words - n_rows * LANES
            lane[:k] = lane[:k] * P + words[n_rows, :k]
        acc = SEED ^ (np.uint64(nbytes) * Q)
        for lv in lane:
            acc = acc * Q + lv
    return int(_avalanche64(acc))


TPU_LANES = 65536
_TPA, _TSA = np.uint32(0x01000193), np.uint32(0x811C9DC5)
_TPB, _TSB = np.uint32(0x85EBCA6B), np.uint32(0x9E3779B9)
_MC1, _MC2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
_MC5, _MC6 = np.uint32(5), np.uint32(0xE6546B64)


def _u32_powers(p: np.uint32, n: int) -> np.ndarray:
    """[p^n-1 ... p^1 p^0] mod 2^32 (the row weights for n rows)."""
    with np.errstate(over="ignore"):
        out = np.empty(n, dtype=np.uint32)
        acc = np.uint32(1)
        for i in range(n - 1, -1, -1):
            out[i] = acc
            acc = acc * p
    return out


def _rotl32(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix2(h, k):
    """murmur3 stream step as a 2 -> 1 lane combiner (h absorbs k). It must
    be non-linear with rotations: a linear fold of identical halves (what
    uniform content such as zero-initialised parameters gives) cancels, and
    every constant array would hash alike."""
    k = _rotl32(k * _MC1, 15) * _MC2
    return _rotl32(h ^ k, 13) * _MC5 + _MC6


def _tpu_fold(lane_a, lane_b):
    """16 levels of _mix2, each halving the lane vector."""
    half = TPU_LANES // 2
    while half >= 1:
        lane_a = _mix2(lane_a[:half], lane_a[half:2 * half])
        lane_b = _mix2(lane_b[:half], lane_b[half:2 * half])
        half //= 2
    return lane_a[0], lane_b[0]


def _tpu_finalize(acc_a, acc_b, nbytes: int) -> int:
    """The 64-bit tail, on the host: concatenate the planes, mix in the
    length, avalanche."""
    with np.errstate(over="ignore"):
        d = (np.uint64(acc_a) << np.uint64(32)) | np.uint64(acc_b)
        return int(_avalanche64(d ^ (np.uint64(nbytes) * Q)))


def simplehash_tpu(buf) -> int:
    """numpy twin of hash type 2 (`simple-tpu`). Bit-identical to the C++
    pcclt::hash::simplehash_tpu and to H1."""
    data = _as_bytes(buf)
    nbytes = data.size
    n_words = (nbytes + 3) // 4
    rows = (n_words + TPU_LANES - 1) // TPU_LANES
    padded = np.zeros(max(rows, 1) * TPU_LANES * 4, dtype=np.uint8)
    padded[:nbytes] = data
    words = padded.view("<u4").reshape(-1, TPU_LANES)[:rows]

    with np.errstate(over="ignore"):
        wa = _u32_powers(_TPA, rows)[:, None]
        wb = _u32_powers(_TPB, rows)[:, None]
        pa_rows = (wa[0, 0] * _TPA) if rows else np.uint32(1)  # PA^rows
        pb_rows = (wb[0, 0] * _TPB) if rows else np.uint32(1)
        lane_a = (words * wa).sum(axis=0, dtype=np.uint32) + _TSA * pa_rows
        lane_b = (words * wb).sum(axis=0, dtype=np.uint32) + _TSB * pb_rows
        a, b = _tpu_fold(lane_a, lane_b)
    return _tpu_finalize(a, b, nbytes)


# ------------------------------------------------------------ plain version

# torch has no general u32 arithmetic: the plain version holds u32 values
# in int64 and masks to 32 bits after every operation. A product of two
# u32 would overflow int64, so it is split at 16 bits.
_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """x * c mod 2^32 for u32 values x (int64 tensor) and c (an int or an
    int64 tensor of u32 values)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _mix2_plain(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = _mul32(_rotl(_mul32(k, int(_MC1)), 15), int(_MC2))
    return (_mul32(_rotl(h ^ k, 13), int(_MC5)) + int(_MC6)) & _MASK


def _pow32_tensor(p: int, e: torch.Tensor) -> torch.Tensor:
    """p ** e mod 2^32 for each exponent of e, by squaring, on e's device
    (no host list, so nothing waits for the card)."""
    out, base = torch.ones_like(e), p
    for bit in range(max(1, int(e.numel()).bit_length())):
        out = torch.where((e >> bit) & 1 == 1, _mul32(out, base), out)
        base = base * base & _MASK
    return out


def _rows(nbytes: int) -> int:
    return -(-((nbytes + 3) // 4) // TPU_LANES)


def planes_plain(t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of H1: the two folded u32 planes of t's
    bytes, as an int64 tensor [2] on t's device."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8)
    nbytes = data.numel()
    if nbytes == 0:
        raise ValueError("a 0-byte tensor has no device planes; hash it "
                         "with simplehash_tpu")
    rows = _rows(nbytes)
    padded = torch.zeros(rows * TPU_LANES * 4, dtype=torch.int64,
                         device=data.device)
    padded[:nbytes] = data
    b = padded.view(rows, TPU_LANES, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    out = []
    exps = rows - 1 - torch.arange(rows, dtype=torch.int64, device=data.device)
    for p, s in ((int(_TPA), int(_TSA)), (int(_TPB), int(_TSB))):
        pows = _pow32_tensor(p, exps)[:, None]
        # rows * 2^32 < 2^63: the column sum cannot overflow
        seed = s * pow(p, rows, 1 << 32) & _MASK
        lane = (_mul32(w, pows).sum(dim=0) + seed) & _MASK
        half = TPU_LANES // 2
        while half >= 1:
            lane = _mix2_plain(lane[:half], lane[half:2 * half])
            half //= 2
        out.append(lane)
    return torch.cat(out)


# ------------------------------------------------------------ H1

# H1 launches since the last reset_launch_counts()
launches = {"simplehash_tpu": 0}


def reset_launch_counts() -> None:
    launches["simplehash_tpu"] = 0


_FN = []


def _kernel():
    if not _FN:
        fn = _build.kernel_lib("simplehash_tpu").pccl_simplehash_tpu
        fn.restype = ctypes.c_int
        # data, nbytes, lanes scratch, out, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def device_planes(t: torch.Tensor) -> torch.Tensor:
    """H1: the two folded u32 planes of t's bytes, as an int64 tensor [2]
    on t's device, not synchronised. A CUDA tensor goes through the kernel
    (its bytes are read in place when contiguous and 16-byte aligned, else
    from a contiguous copy on the card); a CPU tensor through the plain
    version."""
    if t.device.type == "cpu":
        return planes_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"device_planes runs on cuda or cpu, not {t.device}")
    t = t.detach()
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        raise ValueError("a 0-byte tensor has no device planes; hash it "
                         "with simplehash_tpu")
    lanes = torch.empty(2 * TPU_LANES, dtype=torch.int32, device=t.device)
    out = torch.empty(2, dtype=torch.int64, device=t.device)
    with torch.cuda.device(t.device):
        code = _kernel()(t.data_ptr(), nbytes, lanes.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream(t.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"simplehash_tpu kernel launch failed: cudaError {code}")
    launches["simplehash_tpu"] += 1
    return out


def torch_simplehash_device(t: torch.Tensor) -> int:
    """`simple-tpu` digest of a tensor's bytes, computed where the tensor
    lies: only the two u32 planes (8 bytes) cross to the host, which waits
    for them. Bit-identical to simplehash_tpu of the same bytes. A 0-byte
    tensor hashes on the host (the device grid has at least one row)."""
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return simplehash_tpu(np.empty(0, np.uint8))
    a, b = device_planes(t).tolist()
    return _tpu_finalize(np.uint32(a), np.uint32(b), nbytes)
