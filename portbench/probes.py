"""What a peer reads from its own state and from the card for the check and
the per-layer metrics: per-leaf norms and random projections of the
parameters (float64), and, in a traced run, the device's kernels from
torch.profiler with the loop's own host spans on the same wall clock."""

from __future__ import annotations

import contextlib
import time

import torch

# projections a leaf: the rms of K Gaussian projections of a vector x
# estimates |x| (chi with K degrees of freedom)
SKETCH_K = 8
_CHUNK = 1 << 22


@torch.no_grad()
def norm64(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


@torch.no_grad()
def adam_grad_norms(state, beta1: float = 0.9) -> dict:
    """|g| of each leaf's first gradient as AdamW got it, from its state
    after one step: exp_avg = (1 - beta1) g."""
    out = {}
    for name, p in state.params.items():
        st = state.optimizer.state.get(p, {})
        m = st.get("exp_avg")
        out[name] = 0.0 if m is None else norm64(m) / (1.0 - beta1)
    return out


@torch.no_grad()
def change_norms(params: dict, ref_vec: torch.Tensor, codec) -> dict:
    """|params[n] - ref| for each leaf, ref a flat vector in the codec's
    leaf order (a Diloco outer vector)."""
    out = {}
    for n, o, s in zip(codec.names, codec.offsets, codec.sizes):
        out[n] = norm64(params[n].detach().reshape(-1) - ref_vec[o:o + s])
    return out


@torch.no_grad()
def _project(flat: torch.Tensor, gen: torch.Generator) -> list:
    acc = torch.zeros(SKETCH_K, dtype=torch.float64, device=flat.device)
    for i in range(0, flat.numel(), _CHUNK):
        x = flat[i:i + _CHUNK].double()
        r = torch.randn((SKETCH_K, x.numel()), generator=gen,
                        device=flat.device, dtype=torch.float32)
        acc += r.double() @ x
    return acc.tolist()


def _leaf_gen(seed: int, leaf: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 7_777_777 + 104_729 * (leaf + 1)) % (1 << 63))


@torch.no_grad()
def sketch(tensors: dict, names: list, seed: int) -> dict:
    """name -> K projections of the leaf on Gaussian vectors drawn from
    (seed, leaf index): the same vectors on every peer."""
    return {n: _project(tensors[n].detach().reshape(-1).float(),
                        _leaf_gen(seed, i, tensors[n].device))
            for i, n in enumerate(names)}


@torch.no_grad()
def sketch_flat(vec: torch.Tensor, codec, seed: int) -> dict:
    """sketch() of a flat vector cut by the codec's leaves."""
    return {n: _project(vec[o:o + s], _leaf_gen(seed, i, vec.device))
            for i, (n, o, s) in enumerate(zip(codec.names, codec.offsets,
                                               codec.sizes))}


class StepClock:
    """When each step ran: on a card, CUDA events on the device's own
    clock, read after the window; on the CPU, the host clock. Time 0 is
    the clock's creation, the start of the window."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.t0 = time.perf_counter()
        self.e0 = None
        if cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()

    def mark(self):
        if not self.cuda:
            return time.perf_counter() - self.t0
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, m) -> float:
        return self.e0.elapsed_time(m) / 1e3 if self.cuda else m

    def share_in_window(self, steps: list, window_s: float) -> float:
        """Steps done inside [0, window_s]: each (start, end) mark pair
        counts by the share of its time inside the window, so the count
        has no step of granularity."""
        if self.cuda:
            torch.cuda.synchronize()
        done = 0.0
        for a, b in steps:
            s, e = self.seconds(a), self.seconds(b)
            if e <= window_s:
                done += 1.0
            elif s < window_s:
                done += (window_s - s) / (e - s)
        return done


def kernel_key(name: str) -> str:
    """A device op's name without its return type and arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:96]


class Tracer:
    """Host spans (name, start ns, end ns on the wall clock) of the loop,
    and, where `on` and the peer has a card, torch.profiler's device
    activity over the window. Off, span() records nothing and costs a
    context manager."""

    def __init__(self, on: bool, dev):
        self.on = bool(on)
        self.device = self.on and dev.type == "cuda"
        self.spans = []
        self._prof = None

    def start(self) -> None:
        if self.device:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def add_span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        if self.on:
            self.spans.append((name, t0_ns, t1_ns))

    def report(self, w0_ns: int, w1_ns: int) -> dict:
        """The window [w0, w1] on the wall clock: the device's busy
        intervals (the union of every kernel, copy and set), each op's
        calls and seconds by name (clipped to the window), and the host
        spans."""
        out = {"window_ns": [w0_ns, w1_ns], "spans": self.spans,
               "busy_ns": [], "ops": {}}
        if self._prof is None:
            return out
        dev_type = torch.autograd.DeviceType.CUDA
        evs = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != dev_type:
                continue
            s = e.start_ns()
            t = s + e.duration_ns()
            if t <= w0_ns or s >= w1_ns:
                continue
            evs.append((max(s, w0_ns), min(t, w1_ns), e.name()))
        evs.sort()
        busy, ops = [], {}
        for s, t, name in evs:
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], t)
            else:
                busy.append([s, t])
            rec = ops.setdefault(kernel_key(name), [0, 0])
            rec[0] += 1
            rec[1] += t - s
        out["busy_ns"] = busy
        out["ops"] = ops
        return out
