"""On the card only: torch.profiler, as the harness's Tracer runs it, sees
the ctypes-launched K1-K3 and H1 with their device times."""

import time

import pytest
import torch

from portbench import probes


@pytest.mark.cuda
def test_tracer_sees_the_kernels(card):
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops.hashing import torch_simplehash_device

    q, k, v = (torch.randn(2, 1024, 16, 64, device=card, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    x = torch.randn(1 << 22, device=card)
    fa.flash_attention(q, k, v).sum().backward()
    torch_simplehash_device(x)
    torch.cuda.synchronize()
    tracer = probes.Tracer(True, card)
    t0 = time.time_ns()
    tracer.start()
    fa.flash_attention(q, k, v).sum().backward()
    torch_simplehash_device(x)
    tracer.stop()
    rep = tracer.report(t0, time.time_ns())
    ops = rep["ops"]
    for tag in ("flash_fwd_kernel<", "flash_bwd_dq_kernel<", "flash_bwd_dkv_kernel<",
                "simplehash_tpu"):
        hits = [v for name, v in ops.items() if tag in name]
        assert hits and all(calls >= 1 and ns > 0 for calls, ns in hits), (tag, ops)
    assert rep["busy_ns"] and all(b > a for a, b in rep["busy_ns"])
