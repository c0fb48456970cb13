"""The port's example plumbing against the JAX examples on the CPU (data,
schedule, config), and checkpoint resume of the port's sync_diloco and
train_ddp: solo in this process, and two DDP peers over the native ring
through the revision-0 probe.

Data must be bit-equal to the JAX examples' (examples/common.py, loaded
from its file): the text corpus, and make_batch_fn's train and val
streams of both kinds. The shifted schedule of a resumed sync DiLoCo run
is held to JAX's make_schedule(offset=) at 1e-6. A resumed DDP run restores
AdamW's state and drains its data, so it ends bit-equal with a run that was
never stopped.
"""

import argparse
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pccl_tpu_torch.examples import common, sync_diloco, train_ddp
from pccl_tpu_torch.ops import _build
from pccl_tpu_torch.parallel import train

REPO = Path(__file__).resolve().parent.parent
# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use
MASTER_PORTS = {"first": 33000, "second": 33010}
PEER_BASE = {"first": 33100, "second": 33200}


def _jax_common():
    """The JAX examples' common.py, loaded from its file under its own name
    (it imports only numpy at module level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_common", REPO / "examples" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**kw):
    base = dict(base_port=56100, data_shard=None, batch=3, block=32,
                data="synthetic", lr_schedule="cosine", warmup_steps=2,
                min_lr=1e-5, family="gpt", model="nano")
    base.update(kw)
    return argparse.Namespace(**base)


def test_text_corpus_is_jaxs():
    got = common.text_corpus()
    want = _jax_common().text_corpus()
    assert got.dtype == np.uint8 and len(got) > 64 * 1024
    assert got.tobytes() == want.tobytes()


def test_text_batch_is_jaxs():
    corpus = common.text_corpus()
    got = common.text_batch(corpus, np.random.RandomState(3), 4, 48)
    want = _jax_common().text_batch(corpus, np.random.RandomState(3), 4, 48)
    for x, w in zip(got, want):
        assert x.dtype == np.int32 and x.shape == (4, 48)
        np.testing.assert_array_equal(x, w)
    np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("kind", ["synthetic", "text"])
def test_batches_are_jaxs(kind, split):
    args = _args(data=kind)
    got = common.make_batch_fn(args, 256, split)
    want = _jax_common().make_batch_fn(args, 256, split)
    for _ in range(4):
        (x, y), (wx, wy) = got(), want()
        assert x.dtype == np.int32 and x.shape == (3, 32)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def test_val_split_is_held_out_and_shards_differ():
    """Text val batches come from the corpus's last 10 %, train batches from
    the rest; --data-shard picks the stream as the base port would."""
    corpus = common.text_corpus()
    cut = int(len(corpus) * 0.9)
    tail = corpus[cut:].tobytes()
    head = corpus[:cut].tobytes()
    val = common.make_batch_fn(_args(data="text"), 256, "val")()[0]
    trn = common.make_batch_fn(_args(data="text"), 256, "train")()[0]
    for row in val:
        assert row.astype(np.uint8).tobytes() in tail
    for row in trn:
        assert row.astype(np.uint8).tobytes() in head
    by_shard = common.make_batch_fn(_args(data="text", base_port=1, data_shard=56100),
                                    256)()
    np.testing.assert_array_equal(by_shard[0], trn)
    other = common.make_batch_fn(_args(data="text", base_port=56101), 256)()
    assert not np.array_equal(other[0], trn)


@pytest.mark.parametrize("offset", [0, 5])
def test_schedule_offset_is_jaxs(offset):
    args = _args()
    got = common.make_schedule(args, 1e-3, 20, offset=offset)
    want = _jax_common().make_schedule(args, 1e-3, 20, offset=offset)
    for count in range(25):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"count {count}")
    assert common.make_schedule(_args(lr_schedule="const"), 1e-3, 20) is None


def test_char_level_config_has_a_byte_vocab():
    cfg = common.model_config(_args(block=48), char_level=True)
    assert cfg.vocab_size == 256 and cfg.block_size == 48
    llama = common.model_config(_args(family="llama", model="tiny"), char_level=True)
    assert llama.vocab_size == 256
    assert common.model_config(_args(model="tiny")).vocab_size == 512


# ------------------------------------------------------------ solo resume

@pytest.fixture
def one_thread():
    """The examples run in this process at nano size, where torch's thread
    pool only contends with the other test workers: one thread, restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DILOCO_ARGS = ["--solo", "--device", "cpu", "--model", "nano", "--inner-steps", "3",
               "--data", "text", "--lr-schedule", "cosine", "--warmup-steps", "2",
               "--inner-lr", "1e-3", "--checkpoint-every", "1", "--no-descent-check"]


def test_sync_diloco_resumes_solo(tmp_path, monkeypatch, capsys, one_thread):
    """Two outer steps with a checkpoint after each; then a run to three
    resumes at outer step 2 with the outer state that step 1 left (its
    digest), a fresh AdamW whose schedule is shifted by 2 * 3 inner steps
    (JAX's make_schedule(offset=6)), and the data stream drained past the 6
    batches already used."""
    ck = str(tmp_path / "ck")
    assert sync_diloco.main(DILOCO_ARGS + ["--outer-steps", "2",
                                           "--checkpoint-dir", ck]) == 0
    first = capsys.readouterr().out
    digests = re.findall(r"^outer \d+ .* digest (\w+)$", first, re.M)
    assert len(digests) == 2 and "resumed" not in first
    assert re.findall(r"^checkpoint outer step (\d+) bytes \d+", first, re.M) == ["1", "2"]

    schedules, trained = [], []
    make_state, build_step = train.make_train_state, train.build_train_step

    def spy_state(*a, **kw):
        schedules.append(kw.get("schedule"))
        return make_state(*a, **kw)

    def spy_step(*a, **kw):
        step = build_step(*a, **kw)

        def wrapped(state, tok, tgt):
            trained.append(tok.numpy().copy())
            return step(state, tok, tgt)
        return wrapped

    monkeypatch.setattr(train, "make_train_state", spy_state)
    monkeypatch.setattr(train, "build_train_step", spy_step)
    assert sync_diloco.main(DILOCO_ARGS + ["--outer-steps", "3",
                                           "--checkpoint-dir", ck]) == 0
    out = capsys.readouterr().out
    m = re.search(r"^resumed from outer step (\d+) digest (\w+) restore_s \S+$", out, re.M)
    assert m and m.group(1) == "2" and m.group(2) == digests[1], out
    assert re.findall(r"^outer (\d+) ", out, re.M) == ["2"]
    assert re.search(r"^outer 2 loss \S+ world 1 revision 3 ", out, re.M), out

    # the schedule: the first state's is the run's own, the rebuilt one is
    # shifted by the 6 inner steps already run
    assert len(schedules) == 2
    args = _args(lr_schedule="cosine", warmup_steps=2, min_lr=0.0)
    want = _jax_common().make_schedule(args, 1e-3, 9, offset=6)
    for count in range(4):
        np.testing.assert_allclose(schedules[1](count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    assert schedules[1](0) != schedules[0](0)

    # the data: the 7th to 9th batches of this peer's stream
    stream = common.make_batch_fn(argparse.Namespace(
        data="text", base_port=56000, data_shard=None, block=64, batch=8), 256)
    batches = [stream()[0] for _ in range(9)]
    assert len(trained) == 3
    for got, want_tok in zip(trained, batches[6:]):
        np.testing.assert_array_equal(got, want_tok)


DDP_ARGS = ["--solo", "--device", "cpu", "--model", "nano", "--batch", "2",
            "--grad-accum", "2", "--data", "text", "--lr-schedule", "cosine",
            "--warmup-steps", "2", "--no-descent-check"]


def test_train_ddp_resumes_solo_bit_equal(tmp_path, capsys, one_thread):
    """Three steps of two microbatches with a checkpoint at step 3, then a
    run to six resumes at step 3 and ends with the parameters of a six-step
    run that never stopped: AdamW's moments, count and schedule come back,
    and the stream is drained by 3 * 2 batches."""
    ck = str(tmp_path / "ck")
    assert train_ddp.main(DDP_ARGS + ["--steps", "3", "--checkpoint-dir", ck,
                                      "--checkpoint-every", "3"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^checkpoint step 3 bytes \d+ save_s \S+$", out, re.M), out
    assert train_ddp.main(DDP_ARGS + ["--steps", "6", "--checkpoint-dir", ck,
                                      "--checkpoint-every", "3"]) == 0
    resumed = capsys.readouterr().out
    assert re.search(r"^resumed from step 3 restore_s \S+$", resumed, re.M), resumed
    assert re.findall(r"^step (\d+) ", resumed, re.M) == ["3", "4", "5"]
    # solo, the first offer is the checkpoint's step (no cohort to probe)
    assert train_ddp.main(DDP_ARGS + ["--steps", "6"]) == 0
    whole = capsys.readouterr().out

    def final(text):
        return re.search(r"params_blake2b=(\w+)", text).group(1)

    assert final(resumed) == final(whole)
    digests = dict(re.findall(r"^step (\d+) .* digest (\w+)$", whole, re.M))
    assert dict(re.findall(r"^step (\d+) .* digest (\w+)$", resumed, re.M)) == \
        {s: d for s, d in digests.items() if int(s) >= 3}


def test_train_ddp_eval_and_accumulation_lines(capsys, one_thread):
    """--eval-every prints the held-out loss; with --grad-accum 2 a step
    counts A * B * T tokens (its loss is the mean of two microbatches)."""
    assert train_ddp.main(DDP_ARGS + ["--steps", "4", "--eval-every", "2",
                                      "--eval-batches", "2", "--profile"]) == 0
    out = capsys.readouterr().out
    evals = re.findall(r"^eval step (\d+) loss (\S+) launches (\d+)$", out, re.M)
    assert [e[0] for e in evals] == ["1", "3"]
    assert all(np.isfinite(float(e[1])) for e in evals)
    for name in ("fwd+bwd", "ring/all_reduce", "apply", "eval"):
        assert re.search(rf"^{re.escape(name)}\s+\d+", out, re.M), name
    with pytest.raises(SystemExit):
        train_ddp.main(DDP_ARGS[:-1] + ["--grad-accum", "0"])


# ------------------------------------------------------------ two peers

def _lib():
    """libpcclt.so, built once into pccl_tpu_torch/build/ by the first
    test that needs it (the others wait on its lock)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _run_cohort(lib, run, ck_root, steps):
    """A master and two train_ddp peers on the CPU, on the ports of `run`,
    each with its own checkpoint directory; returns both peers' output."""
    port = MASTER_PORTS[run]
    env = dict(os.environ, PCCLT_LIB=str(lib), OMP_NUM_THREADS="1",
               PCCLT_SS_HASH="simple-tpu", PYTHONUNBUFFERED="1")
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    peers = []
    try:
        for rank in range(2):
            peers.append(subprocess.Popen(
                [sys.executable, "-m", "pccl_tpu_torch.examples.train_ddp",
                 "--master-port", str(port), "--base-port", str(PEER_BASE[run] + 16 * rank),
                 "--min-world", "2", "--device", "cpu", "--model", "nano",
                 "--batch", "2", "--grad-accum", "2", "--data", "text",
                 "--eval-every", "2", "--eval-batches", "1",
                 "--checkpoint-dir", str(ck_root / f"peer{rank}"),
                 "--checkpoint-every", "4", "--steps", str(steps),
                 "--data-shard", str(rank), "--no-descent-check"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=240)[0] for p in peers]
    finally:
        for p in peers + [master]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(peers, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


STEP = re.compile(r"^step (\d+) loss \S+ world (\d+) revision (\d+) .* tx (\d+) "
                  r"rx (\d+) launches .* digest (\w+)$", re.M)


def test_two_ddp_peers_resume_through_the_revision_zero_probe(tmp_path):
    """Two peers run 4 steps and checkpoint; both stop, and against a fresh
    master both resume at step 4. With another peer in the world, each
    first offers revision 0 (a probe that cannot be kicked), whatever its
    step: the election agrees at revision 0 without moving a byte (both
    restored the same state), and the revisions go on from there. Digests
    are equal at every step, and so are the final parameters."""
    lib = _lib()
    first = _run_cohort(lib, "first", tmp_path, 4)
    second = _run_cohort(lib, "second", tmp_path, 7)
    for out in second:
        assert re.search(r"^resumed from step 4 restore_s \S+$", out, re.M), out
        assert re.search(r"^eval step 5 loss \S+", out, re.M), out
    rows = [{int(r[0]): r[1:] for r in STEP.findall(out)} for out in first + second]
    assert sorted(rows[0]) == sorted(rows[1]) == [0, 1, 2, 3]
    assert sorted(rows[2]) == sorted(rows[3]) == [4, 5, 6]
    for r in rows[2:]:
        assert [r[s][1] for s in (4, 5, 6)] == ["0", "1", "2"]
        assert all(r[s][0] == "2" and r[s][2:4] == ("0", "0") for s in r)
    for a, b in (rows[:2], rows[2:]):
        assert {s: a[s][4] for s in a} == {s: b[s][4] for s in b}
    finals = {re.search(r"params_blake2b=(\w+)", out).group(1) for out in second}
    assert len(finals) == 1
