"""The port's copies of the native-stack benchmarks on the CPU
(pccl_tpu_torch.comm.native_bench and pybench, utils/trace_critic.py).

The pure helpers equal the JAX package's (the port layout and the per-edge
wire maps, the trace attribution); the numpy legs run at small sizes over
a real master; the DiLoCo outer-step leg runs with its outer state on the
CPU, where its ranks' digests must agree and the outer vector match the
closed form of the synthetic step. The card-only legs refuse the CPU.

Every leg gets its master port and port base from this file's band,
16000-18999 (bases + 1000 and + 2000 included), which no other test file
uses. The library is built once into pccl_tpu_torch/build/ (under a lock);
the tests skip only without g++.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from pccl_tpu.comm import native_bench as jax_nb
from pccl_tpu_torch.comm import native_bench as nb
from pccl_tpu_torch.comm import pybench
from pccl_tpu_torch.ops import _build

# (master port, port base) of each leg: masters 16000-16099, bases from
# 16100 on, 64 apart
_LEGS = ("fp32", "bf16", "shared_state", "diloco", "attribution", "pybench")
PORTS = {leg: (16001 + 2 * i, 16100 + 64 * i) for i, leg in enumerate(_LEGS)}


@pytest.fixture(scope="module", autouse=True)
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


@pytest.mark.parametrize("base,rank", [(2000, 0), (2000, 3), (45000, 1),
                                       (16100, 7)])
def test_rank_ports_match_jax(base, rank):
    assert nb._rank_ports(base, rank) == jax_nb._rank_ports(base, rank)


WIRES = [
    dict(world=2, port_base=16100, mbps=100.0),
    dict(world=4, port_base=5000, mbps=[[None, 25.0, 200.0, 200.0],
                                        [25.0, None, 200.0, 200.0],
                                        [200.0, 200.0, None, 200.0],
                                        [200.0, 200.0, 200.0, None]],
         rtt_ms={(0, 1): 60.0, (1, 0): 60.0}),
    dict(world=3, port_base=34200, rtt_ms=50.0, jitter_ms=2.0, drop=0.01),
    dict(world=2, port_base=16100, mbps=800.0, host="::1"),
]


@pytest.mark.parametrize("kw", WIRES, ids=["uniform", "matrix+dict", "rtt-jitter-drop",
                                           "v6"])
def test_wire_topology_matches_jax(kw):
    with nb.wire_topology(**kw) as port, jax_nb.wire_topology(**kw) as ref:
        assert port == ref


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_allreduce_bench(dtype):
    mport, base = PORTS[dtype]
    if dtype == "fp32":
        stats = nb.run_allreduce_bench(nbytes=1 << 20, iters=2, master_port=mport,
                                       port_base=base, return_stats=True)
        assert 0 < stats["min"] <= stats["med"] <= stats["max"]
        assert "phases" in stats
    else:
        # the peers assert the exact bf16 sum themselves
        assert nb.run_allreduce_bench_bf16(nbytes=1 << 20, iters=2,
                                           master_port=mport, port_base=base) > 0


def test_shared_state_bench():
    mport, base = PORTS["shared_state"]
    assert nb.run_shared_state_bench(world=2, elems=1 << 16, iters=2,
                                     master_port=mport, base=base) > 0


def test_diloco_outer_bench_on_cpu():
    mport, base = PORTS["diloco"]
    med, phases, ranks = nb.run_diloco_outer_bench(
        world=2, params_n=1 << 16, outer_steps=2, master_port=mport, base=base,
        device="cpu", details=True)
    assert med > 0 and phases["total"] > 0
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    steps = 2 + 2 + 1               # timed, warmup, profiled
    want = nb.diloco_closed_form(2, steps)
    for r in ranks:
        assert r["steps"] == steps and r["platform"] == "cpu"
        assert r["w_min"] == r["w_max"] == r["first"]
        assert r["first"] == pytest.approx(want, rel=1e-5)
        assert r["peak_rss_mib"] > 0


def test_diloco_closed_form():
    """One step by hand: d = 0.015, mom = d, upd = d + 0.9 d, outer = -0.7 upd."""
    assert nb.diloco_closed_form(2, 1) == pytest.approx(-0.7 * 1.9 * 0.015)
    assert nb.diloco_closed_form(3, 0) == 0.0


@pytest.mark.parametrize("runner", ["run_diloco_cuda_bench",
                                    "run_async_diloco_cuda_bench"])
def test_cuda_legs_refuse_the_cpu(runner):
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(nb, runner)(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(nb, runner)()


def test_attribution_bench_runs_the_copied_critic():
    mport, base = PORTS["attribution"]
    r = nb.run_attribution_bench(nbytes=1 << 20, iters=2, base=base,
                                 master_port=mport)
    assert r["attribution_ops"] >= 2
    assert 0 < r["attribution_coverage"] <= 1
    assert r["attribution_verdict"]


def test_trace_critic_copy_matches_tools(tmp_path):
    from pccl_tpu_torch.utils import trace_critic
    from tools import trace_critic as ref

    def op(seq, dur, stall, edge):
        args = {"epoch": 1, "seq": seq}
        return [
            {"ph": "X", "name": "allreduce", "ts": 100.0 * seq, "dur": dur,
             "args": args},
            {"ph": "X", "name": "commence_wait", "ts": 100.0 * seq, "dur": 5.0,
             "args": args},
            {"ph": "X", "name": "op_setup", "ts": 100.0 * seq + 5, "dur": 3.0,
             "args": args},
            {"ph": "X", "name": "rs_stage", "ts": 100.0 * seq + 8, "dur": dur - 8,
             "args": {**args, "stage": 0, "stall_ns": stall * 1e3, "detail": edge}},
            {"name": "quantize", "args": {**args, "ns": 2000}},
        ]

    docs = [{"traceEvents": op(1, 50.0, 30.0, "127.0.0.1:1") + op(2, 40.0, 1.0, "a")},
            op(1, 45.0, 2.0, "127.0.0.1:2") + [{"ph": "X", "name": "allreduce",
                                                  "ts": 0, "dur": 1, "args": {}}]]
    paths = []
    for i, d in enumerate(docs):
        paths.append(tmp_path / f"peer{i}.json")
        paths[-1].write_text(json.dumps(d))
    assert trace_critic.analyze_files(paths) == ref.analyze_files(paths)
    assert trace_critic.analyze_docs(docs, ["a", "b"]) == \
        ref.analyze_docs(docs, ["a", "b"])


def test_pybench_allreduce():
    port, _ = PORTS["pybench"]
    # the peers check the sum themselves
    assert pybench.run_allreduce_bench(nbytes=1 << 20, iters=2, port=port) > 0


def test_diloco_1b_host_bytes():
    """The pinned buffer rounds up to a power of two; the shm stages and
    the digest's copy do not."""
    vec = 4 * 10 ** 9
    assert nb.diloco_1b_host_bytes(2, 10 ** 9) == 2 * ((1 << 32) + 3 * vec + (2 << 30))
    assert nb.diloco_1b_host_bytes(1, 1 << 20) == (4 << 20) * 4 + (2 << 30)
    assert np.isclose(nb.diloco_1b_host_bytes() / 2 ** 30, 2 * (4 + 3 * 3.725 + 2),
                      rtol=1e-3)


def test_smoke_free_ports_skips_bases_past_65535(monkeypatch):
    """chip_smoke's port picker (portbench.run.free_ports): a kernel may
    hand out a base so high that base + 2004 (a native_bench peer's bench
    port) passes 65535; such a base is skipped, not raised on."""
    import socket
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    real = socket.socket
    handed = []

    class HighFirst(real):
        def bind(self, addr):
            if addr[1] == 0 and not handed:
                handed.append(64999)
                return real.bind(self, ("127.0.0.1", 64999))
            return real.bind(self, addr)

    monkeypatch.setattr(socket, "socket", HighFirst)
    bases = chip_smoke.free_ports(2, offsets=chip_smoke.BENCH_OFFSETS)
    assert handed == [64999] and 64999 not in bases
    assert all(b + max(chip_smoke.BENCH_OFFSETS) <= 65535 for b in bases)
