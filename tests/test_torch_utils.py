"""pccl_tpu_torch.utils (TokenDataset, Profiler, Checkpointer,
DilocoCheckpoint) against pccl_tpu.utils on the CPU.

TokenDataset is a copy and must give bit-equal batches for the same
(seed, worker_index). The profiler is held to the JAX package's test of its
own, except that the trace counts the `process_name` metadata event the
export writes first. The checkpoints round-trip exactly; a port Diloco and
a JAX Diloco restore equal outer vectors, momentum and step after the same
outer steps (the port's apply is bit-equal with JAX's on the CPU).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pccl_tpu.parallel import diloco as jdiloco
from pccl_tpu.utils import checkpoint as jcheckpoint
from pccl_tpu.utils import data as jdata
from pccl_tpu_torch.parallel import diloco
from pccl_tpu_torch.utils import checkpoint, data
from pccl_tpu_torch.utils.profiler import Profiler


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
    prof = Profiler()
    with prof.section("s"):
        pass
    t0_us = prof._t0 * 1e6
    native = [{"name": "ring", "ph": "X", "pid": 7, "ts": t0_us + 50.0, "dur": 3},
              {"name": "early", "ph": "i", "pid": 7, "ts": t0_us - 10.0},
              {"name": "meta", "ph": "M", "pid": 7}]
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path), native_events=native)
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["process_name", "s", "ring", "early", "meta"]
    assert events[2]["ts"] == pytest.approx(50.0) and events[2]["pid"] == 7
    assert events[3]["ts"] == 0.0
    assert native[0]["ts"] == t0_us + 50.0          # the caller's dicts stay
    with pytest.raises(FileExistsError):
        prof.export_chrome_trace(str(path), overwrite=False)


def test_disabled_profiler_records_nothing():
    prof = Profiler(enabled=False)
    with prof.section("x"):
        pass
    assert prof.stats() == {} and prof.summary() == "(no sections recorded)"


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
