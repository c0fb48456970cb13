"""Shared-state hash benchmark on the card: the clean-sync invariant.

The twin of pccl_tpu/benchmarks/hash_bench.py. A clean shared-state sync
must not stage device memory to the host: H1 (ops/hashing.py,
`torch_simplehash_device`, hash type 2) computes the digest on the card and
only 8 bytes cross to the host. This bench times it against the staging
path (the whole tensor copied to the host, then the numpy twin
`simplehash_tpu`) at growing state sizes, and holds the two digests equal.

    python -m pccl_tpu_torch.benchmarks.hash_bench

prints one JSON line: `devhash_{N}mb_s` at every size, `stagehash_{N}mb_s`
at 64 MB and below, and `h1_launches`.
"""

from __future__ import annotations

import time
from typing import Dict


def run_hash_bench(sizes_mb=(16, 64, 256), device="cuda") -> Dict[str, float]:
    """Seconds of the device digest and of the staging digest of `mb` MiB
    of seeded fp32 data on `device` (a CUDA card unless "cpu" is asked
    for), and H1's launches."""
    import torch

    from .._device import resolve_device
    from ..ops import hashing

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    hashing.reset_launch_counts()
    out: Dict[str, float] = {}
    for mb in sizes_mb:
        n = mb * (1 << 20) // 4
        arr = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        # device digest: its 8-byte readback is the fence
        h_dev = hashing.torch_simplehash_device(arr)    # warm-up, loads H1
        t0 = time.perf_counter()
        h_dev = hashing.torch_simplehash_device(arr)
        out[f"devhash_{mb}mb_s"] = time.perf_counter() - t0

        # staging path: the whole tensor to the host, then the numpy twin
        if mb <= 64:
            t0 = time.perf_counter()
            h_host = hashing.simplehash_tpu(arr.cpu().numpy())
            out[f"stagehash_{mb}mb_s"] = time.perf_counter() - t0
            assert h_host == h_dev, "device/host digest parity broke"
        del arr
    out["h1_launches"] = hashing.launches["simplehash_tpu"]
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(run_hash_bench()))
