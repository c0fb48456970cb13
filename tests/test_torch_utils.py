"""pccl_tpu_torch.utils (TokenDataset, Profiler, Checkpointer,
DilocoCheckpoint) against pccl_tpu.utils on the CPU, and the examples'
peak host memory (utils/rss.py).

TokenDataset is a copy and must give bit-equal batches for the same
(seed, worker_index). The profiler is held to the JAX package's test of its
own, except that the trace counts the `process_name` metadata event the
export writes first. The checkpoints round-trip exactly; a port Diloco and
a JAX Diloco restore equal outer vectors, momentum and step after the same
outer steps (the port's apply is bit-equal with JAX's on the CPU).
"""

import json
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pccl_tpu.parallel import diloco as jdiloco
from pccl_tpu.utils import checkpoint as jcheckpoint
from pccl_tpu.utils import data as jdata
from pccl_tpu_torch.parallel import diloco
from pccl_tpu_torch.utils import checkpoint, data
from pccl_tpu_torch.utils.profiler import DEVICE_TID, Profiler


# ------------------------------------------------------------ TokenDataset

@pytest.mark.parametrize("seed,worker", [(0, 0), (1000, 3), (7919, 996)])
def test_token_dataset_streams_are_jaxs(seed, worker):
    tokens = np.random.RandomState(5).randint(0, 256, 5000).astype(np.uint8)
    got = data.TokenDataset(tokens, 64, 4, seed=seed, worker_index=worker)
    want = jdata.TokenDataset(tokens, 64, 4, seed=seed, worker_index=worker)
    for _ in range(5):
        (x, y), (wx, wy) = got.sample(), want.sample()
        assert x.dtype == y.dtype == np.int32 and x.shape == (4, 64)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])


def test_token_dataset_workers_differ_and_refuse_bad_input():
    tokens = np.arange(1000, dtype=np.int64) % 256
    a = data.TokenDataset(tokens, 16, 2, seed=1, worker_index=0).sample()
    b = data.TokenDataset(tokens, 16, 2, seed=1, worker_index=1).sample()
    assert not np.array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="1-D"):
        data.TokenDataset(tokens.reshape(10, 100), 16, 2)
    with pytest.raises(ValueError, match="need > block_size"):
        data.TokenDataset(tokens[:17], 16, 2)


# ------------------------------------------------------------ Profiler

def test_profiler_sections_and_trace(tmp_path):
    """The JAX package's profiler test: nested sections, the table, reset;
    the trace holds the process_name event and one event per section
    entered (4, where the JAX test expects 3)."""
    prof = Profiler()
    with prof.section("a"):
        with prof.section("b"):
            pass
    with prof.section("a"):
        pass
    stats = prof.stats()
    assert stats["a"].count == 2 and stats["b"].count == 1
    assert stats["a"].total_s >= stats["a"].max_s >= stats["a"].min_s >= 0
    table = prof.summary()
    assert "a" in table and "mean_ms" in table
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == 4
    assert events[0] == {"ph": "M", "name": "process_name", "pid": 0,
                         "args": {"name": "python"}}
    assert sorted(e["name"] for e in events[1:]) == ["a", "a", "b"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events[1:])
    prof.reset()
    assert prof.stats() == {}
    assert prof.summary() == "(no sections recorded)"


def test_profiler_merges_native_events_and_refuses_overwrite(tmp_path):
    """The flight recorder's events (CLOCK_MONOTONIC microseconds) land on
    the sections' clock, shifted by the one offset the profiler measured
    when it was made; an event stamped now reads now."""
    prof = Profiler()
    with prof.section("s"):
        pass
    now_us = time.monotonic_ns() / 1e3
    native = [{"name": "ring", "ph": "X", "pid": 7, "ts": now_us, "dur": 3},
              {"name": "early", "ph": "i", "pid": 7, "ts": now_us - 10.0},
              {"name": "meta", "ph": "M", "pid": 7}]
    wall_us = time.time_ns() / 1e3
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path), native_events=native)
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["process_name", "s", "ring", "early", "meta"]
    off = prof.monotonic_offset_us
    assert events[2]["ts"] == now_us + off and events[2]["pid"] == 7
    assert events[3]["ts"] == now_us - 10.0 + off
    assert abs(events[2]["ts"] - wall_us) < 5e3
    assert "ts" not in events[4]
    assert native[0]["ts"] == now_us                # the caller's dicts stay
    with pytest.raises(FileExistsError):
        prof.export_chrome_trace(str(path), overwrite=False)


def test_profiler_stamps_on_the_time_ns_clock(tmp_path):
    """Sections are stamped with time.time_ns(), torch.profiler's kernel
    clock: the exported span lies within 5 ms of the stamps taken around
    it, in microseconds."""
    prof = Profiler()
    before = time.time_ns()
    with prof.section("s"):
        time.sleep(0.002)
    after = time.time_ns()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    span = json.loads(path.read_text())["traceEvents"][1]
    assert abs(span["ts"] * 1e3 - before) < 5e6
    assert abs((span["ts"] + span["dur"]) * 1e3 - after) < 5e6
    assert span["dur"] >= 2e3


def test_disabled_profiler_records_nothing():
    prof = Profiler(enabled=False, device="cuda")
    with prof.section("x"):
        pass
    prof.resolve()
    assert prof.stats() == {} and prof.summary() == "(no sections recorded)"


class FakeEvent:
    """torch.cuda.Event on the host: it fires when recorded, at a time the
    test sets on the class."""

    now_ms = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = FakeEvent.now_ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_profiler_device_spans_without_waiting(monkeypatch, tmp_path):
    """On a CUDA device a section records an event at its start and end on
    the current stream and never synchronises; resolve() reads the device
    seconds and the lag of the device's start behind the host's, placed on
    the host clock by an anchor event stamped once it has fired. The
    export gives the device spans their own named row."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "s")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    FakeEvent.now_ms = 0.0
    prof = Profiler(device="cuda")
    for dur_ms in (3.0, 5.0):
        with prof.section("k"):
            FakeEvent.now_ms += dur_ms
    assert prof._pending and not syncs
    FakeEvent.now_ms += 100.0         # the anchor fires 100 ms after the last
    before = time.time_ns()
    prof.resolve()
    after = time.time_ns()
    assert not syncs and not prof._pending
    st = prof.stats()["k"]
    assert st.count == 2 and st.device_count == 2
    assert st.device_s == pytest.approx(0.008)
    assert "device_mean_ms" in prof.summary() and "4.00" in prof.summary()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert events[1] == {"ph": "M", "name": "thread_name", "pid": 0,
                         "tid": DEVICE_TID, "args": {"name": "device"}}
    dev = [e for e in events if e.get("tid") == DEVICE_TID and e["ph"] == "X"]
    host = [e for e in events if e["ph"] == "X" and e["tid"] != DEVICE_TID]
    assert [e["dur"] for e in dev] == pytest.approx([3e3, 5e3])
    # microseconds since the epoch hold a quarter-microsecond step as floats
    assert dev[1]["ts"] - dev[0]["ts"] == pytest.approx(3e3, abs=1)
    # the last span ended 100 ms before the anchor, stamped inside resolve()
    end_us = dev[1]["ts"] + dev[1]["dur"]
    assert before / 1e3 - 100e3 - 1 <= end_us <= after / 1e3 - 100e3 + 1
    # the lag: each device start minus its host start
    assert st.lag_s == pytest.approx(
        sum(d["ts"] - h["ts"] for d, h in zip(dev, host)) / 1e6, abs=1e-5)


def test_profiler_marks_consecutive_phases(monkeypatch):
    """mark(name) closes the phase since the previous mark as a section,
    one event a boundary on a card; the first mark, and one without a
    name, only start. Each section carries the process's CPU seconds,
    and reset() forgets the last mark."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "s")
    FakeEvent.now_ms = 0.0
    prof = Profiler(device="cuda")
    prof.mark("unused")
    for name, ms in (("a", 2.0), ("b", 3.0)):
        FakeEvent.now_ms += ms
        prof.mark(name)
    FakeEvent.now_ms += 50.0
    prof.mark()
    FakeEvent.now_ms += 4.0
    prof.mark("a")
    assert len(prof._pending) == 3
    stats = prof.stats()
    assert list(stats) == ["a", "b"]
    assert stats["a"].count == stats["a"].device_count == 2
    assert stats["a"].device_s == pytest.approx(0.006)
    assert stats["b"].device_s == pytest.approx(0.003)
    assert stats["a"].cpu_s >= 0 and stats["a"].total_s >= 0
    assert "cpu_s" in prof.summary()
    prof.reset()
    prof.mark("c")
    assert prof.stats() == {}
    host = Profiler()
    host.mark()
    time.sleep(0.002)
    host.mark("h")
    assert host.stats()["h"].total_s >= 0.002 and host.stats()["h"].device_count == 0


# ------------------------------------------------------------ Checkpointer

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "b": torch.randn(4, generator=g).bfloat16()},
            "opt_state": [torch.tensor(5, dtype=torch.int32),
                          torch.randn(3, 4, generator=g)],
            "note": 3}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpointer_round_trip_and_retention(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_tree())
    for step in (1, 2, 3):
        ck.save(step, _tree(step))
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert not list((tmp_path / "ck").glob(".*.tmp"))
    template = _tree(0)
    assert _equal(ck.restore(template), _tree(3))
    assert _equal(ck.restore(template, step=2), _tree(2))
    with pytest.raises(FileNotFoundError):
        ck.restore(template, step=1)
    # a second Checkpointer over the same directory sees the same steps
    assert checkpoint.Checkpointer(str(tmp_path / "ck")).latest_step() == 3


@pytest.mark.parametrize("change", ["shape", "dtype", "missing key", "extra leaf",
                                    "leaf type"])
def test_checkpointer_refuses_a_mismatched_template(tmp_path, change):
    ck = checkpoint.Checkpointer(str(tmp_path))
    ck.save(7, _tree(1))
    template = _tree(0)
    if change == "shape":
        template["params"]["w"] = torch.zeros(4, 3)
    elif change == "dtype":
        template["params"]["b"] = template["params"]["b"].float()
    elif change == "missing key":
        del template["params"]["b"]
    elif change == "extra leaf":
        template["opt_state"].append(torch.zeros(1))
    else:
        template["note"] = torch.tensor(3)
    with pytest.raises(ValueError):
        ck.restore(template)


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _np_tree(seed):
    rng = np.random.RandomState(seed)
    return {"z": rng.randn(3, 4).astype(np.float32),
            "a": rng.randn(5).astype(np.float32),
            "b": np.array(rng.randn(), dtype=np.float32)}


def test_diloco_checkpoint_restores_what_jaxs_restores(tmp_path):
    """A port Diloco and a JAX Diloco on the same parameters take the same
    two outer steps, each saves through its own package's DilocoCheckpoint,
    and fresh ones restore: equal outer vectors, momentum and step,
    equal to what was saved."""
    kw = dict(outer_lr=0.7, outer_momentum=0.9)
    jdl = jdiloco.Diloco(None, _jtree(_np_tree(0)), jdiloco.DilocoConfig(**kw))
    tdl = diloco.Diloco(None, {k: torch.from_numpy(v) for k, v in _np_tree(0).items()},
                        diloco.DilocoConfig(**kw))
    for seed in (1, 2):
        jdl.outer_step(_jtree(_np_tree(seed)))
        tdl.outer_step({k: torch.from_numpy(v) for k, v in _np_tree(seed).items()})
    jck = jcheckpoint.DilocoCheckpoint(str(tmp_path / "jax"))
    jck.save(jdl)
    jck.close()
    tck = checkpoint.DilocoCheckpoint(str(tmp_path / "torch"), keep=1)
    tck.save(tdl)
    assert checkpoint.Checkpointer(str(tmp_path / "torch")).steps() == [2]

    jfresh = jdiloco.Diloco(None, _jtree(_np_tree(9)), jdiloco.DilocoConfig(**kw))
    jck = jcheckpoint.DilocoCheckpoint(str(tmp_path / "jax"))
    assert jck.maybe_restore(jfresh) == 2
    jck.close()
    tfresh = diloco.Diloco(None, {k: torch.from_numpy(v) for k, v in _np_tree(9).items()},
                           diloco.DilocoConfig(**kw))
    vec = tfresh.outer_vec
    assert checkpoint.DilocoCheckpoint(str(tmp_path / "torch")).maybe_restore(tfresh) == 2
    assert tfresh.outer_vec is vec                 # restored in place
    assert tfresh.step == jfresh.step == 2
    for got, saved, want in ((tfresh.outer_vec, tdl.outer_vec, jfresh._outer_vec),
                             (tfresh._momentum_vec, tdl._momentum_vec,
                              jfresh._momentum_vec)):
        assert torch.equal(got, saved)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tfresh.digest() == tdl.digest()


def test_diloco_checkpoint_fresh_start_is_step_zero(tmp_path):
    tdl = diloco.Diloco(None, {"w": torch.ones(3)})
    assert checkpoint.DilocoCheckpoint(str(tmp_path)).maybe_restore(tdl) == 0
    assert tdl.step == 0 and torch.equal(tdl.outer_vec, torch.ones(3))


# ------------------------------------------------------------- peak RSS

def test_peak_rss_is_the_process_own():
    """A child spawned by a parent that touched 512 MiB reports its own
    peak (VmHWM), far below the parent's; ru_maxrss, which Linux carries
    over fork and execve, reports at least the parent's buffer, unless
    the child was started through the relay."""
    from pccl_tpu_torch.utils.rss import peak_rss_mib, relay_argv

    big = np.ones(512 << 18, dtype=np.float32)      # 512 MiB, every page
    parent = peak_rss_mib()
    assert parent >= 512
    code = ("import resource\n"
            "from pccl_tpu_torch.utils.rss import peak_rss_mib\n"
            "print(peak_rss_mib(), "
            "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr
    own, maxrss = (int(v) for v in r.stdout.split())
    assert own < parent - 256, (own, parent)
    assert maxrss >= 512, (maxrss, parent)
    assert resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10 >= 512
    # through the relay, ru_maxrss too is the child's own: what a kernel
    # without VmHWM (gVisor) reports
    r = subprocess.run(relay_argv([sys.executable, "-c", code]),
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr
    own, maxrss = (int(v) for v in r.stdout.split())
    assert maxrss < parent - 256 and own < parent - 256, (own, maxrss, parent)
    del big


def test_relay_passes_exit_codes_and_signals():
    """The relay ends as its child does: with its exit code, or killed by
    the signal that ended it; SIGTERM to the relay reaches the child."""
    from pccl_tpu_torch.utils.rss import relay_argv

    r = subprocess.run(relay_argv([sys.executable, "-c",
                                   "import sys; sys.exit(3)"]), timeout=60)
    assert r.returncode == 3
    p = subprocess.Popen(relay_argv([sys.executable, "-c",
                                     "import time; print('up', flush=True); "
                                     "time.sleep(60)"]),
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "up"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == -signal.SIGTERM
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
