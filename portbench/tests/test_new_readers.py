"""The readers of moe_gemm_roofline, outer_ring_s and ring_gbps on made-up
records: what each counts, and None where a run holds nothing to read (a
program without the grouped GEMM, a peer without a ring)."""

import pytest

from portbench import flops, spec
from portbench.tests.conftest import tiny_config


def _cell(config):
    return spec.Cell("x", 1, config, {"batch": 2, "block": 64}, {}, [], [])


def _ctx(cell, ops=None, outer=None):
    rec = {"trace": {"ops": ops or {}}, "outer": outer or []}
    return {"cell": cell, "records": [rec], "flops": flops,
            "device_name": "NVIDIA H100 80GB HBM3"}


def test_moe_gemm_roofline_counts_each_launch_by_variant():
    reader = spec.metric_reader("moe_gemm_roofline")
    cfg = tiny_config("lfm2_moe")
    calls = spec.family("lfm2_moe").moe_gemm_calls(cfg, 2, 64)
    # dropless: 2 x 64 tokens x top-2 rows in every launch
    S = 2 * 64 * cfg["num_experts_per_tok"]
    assert calls["moe_gemm_fwd"][0][0] == 2 * S * 64 * 64
    least = reader.least_s(calls, 989e12, 3.35e12)
    ops = {"moe_gemm::grouped_gemm<0, false, false, false>": [8, 2_000_000],
           "moe_gemm::grouped_gemm<0, false, true, false>": [8, 3_000_000],
           "moe_gemm::grouped_gemm<1, true, false, true>": [8, 5_000_000],
           "flash_fwd_kernel<64>": [4, 9_000_000]}
    got = reader.read(_ctx(_cell(cfg), ops))
    want = 100 * 8 * sum(least.values()) / 0.010
    assert got == pytest.approx(want)
    assert reader.read(_ctx(_cell(cfg), {"flash_fwd_kernel<64>": [4, 9_000_000]})) is None
    assert reader.read(_ctx(_cell(tiny_config("gpt2")), ops)) is None


def test_ring_readers():
    ring_s, gbps = spec.metric_reader("outer_ring_s"), spec.metric_reader("ring_gbps")
    cell = _cell(tiny_config("gpt2"))
    outer = [{"profile": {"ring_reduce": 0.5, "d2h": 0.1}, "tx_bytes": 1_000_000_000},
             {"profile": {"ring_reduce": 1.5, "d2h": 0.1}, "tx_bytes": 3_000_000_000}]
    assert ring_s.read(_ctx(cell, outer=outer)) == pytest.approx(1.0)
    assert gbps.read(_ctx(cell, outer=outer)) == pytest.approx(4e9 * 8 / 2.0 / 1e9)
    alone = [{"profile": {"ring_reduce": 0.0, "d2h": 0.1}, "tx_bytes": 0}]
    assert ring_s.read(_ctx(cell, outer=alone)) is None
    assert gbps.read(_ctx(cell, outer=alone)) is None
    assert ring_s.read(_ctx(cell)) is None and gbps.read(_ctx(cell)) is None
