"""Section profiler for the training loops: named spans on the clock of
torch.profiler's device trace, aggregated per name, with an optional
Chrome trace-event export.

The port of pccl_tpu/utils/profiler.py, with spans on the card besides.
A section stamps the host with time.time_ns(), the clock on which
torch.profiler stamps kernels, so an exported section lines up with the
kernels of a torch.profiler trace of the same process. With a CUDA
`device` a section also records a timing event on the current stream at
its start and at its end. No section waits for the card: the events are
read when the numbers are (stats(), summary(), export_chrome_trace(), or
resolve() called after a synchronisation the caller makes anyway), and
placed on the host clock by one anchor, an event recorded then and
stamped as soon as it has fired. mark(name) closes the phase since the
previous mark, for phases that run back to back (Diloco's outer step).

    prof = Profiler(device=dev)
    for step in range(steps):
        with prof.section("inner"):
            loss = float(step_fn(state, tokens, targets))
        with prof.section("outer/ring+sgd"):
            dl.outer_step(state.params)
        prof.resolve()                       # after a sync: no wait
    print(prof.summary())
    prof.export_chrome_trace("trace.json")   # chrome://tracing or perfetto

Each section reports its host seconds, the process's CPU seconds (all
threads': on a busy host the gap to the host seconds is waiting), its
device seconds (start event to end event) and its lag, the device's start minus the host's: near zero
where the card waits for the host to launch the section's work, large
where the host runs ahead of a busy card.

Sections nest; each records its whole (inclusive) duration, so summary()
rows do not add up across nesting levels. Safe across threads for
disjoint section names. It adds no torch.profiler.record_function
ranges: a CUDA-only torch.profiler run can list those as device rows,
which would cover the card's idle gaps. Imports torch only for a CUDA
device.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List

# the Chrome trace row of the device spans; host rows are thread ids
# masked to 16 bits
DEVICE_TID = 1 << 16


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    cpu_s: float = 0.0       # the process's CPU seconds, all threads'
    device_count: int = 0
    device_s: float = 0.0
    lag_s: float = 0.0       # the sum of device start - host start

    def add(self, dt: float, cpu: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.cpu_s += cpu

    def add_device(self, dt: float, lag: float) -> None:
        self.device_count += 1
        self.device_s += dt
        self.lag_s += lag


class Profiler:
    """Sections by name. enabled=False records nothing (a section costs one
    `if`); device: where it is a CUDA device, sections time the card too.
    max_events bounds the trace's events, and the sections whose device
    events wait to be read (reaching it reads them, which waits)."""

    def __init__(self, enabled: bool = True, device=None,
                 max_events: int = 100_000):
        self.enabled = enabled
        self.max_events = max_events
        self._device = device
        self._cuda = None
        if enabled and device is not None and str(device).startswith("cuda"):
            import torch

            self._cuda = torch.cuda
        self._stats: Dict[str, _Stat] = {}
        self._events: List[dict] = []
        # ended sections whose device events are not read yet:
        # (name, host start ns, start event, end event)
        self._pending: list = []
        self._lock = threading.Lock()
        self._mark_from = None
        # add to a CLOCK_MONOTONIC stamp to put it on this clock
        self.monotonic_offset_us = (time.time_ns() - time.monotonic_ns()) / 1e3

    def _record(self):
        ev = self._cuda.Event(enable_timing=True)
        ev.record(self._cuda.current_stream(self._device))
        return ev

    def _stamp(self) -> tuple:
        """(host ns, process CPU seconds, the event on a card or None)."""
        ev = self._record() if self._cuda is not None else None
        return time.time_ns(), time.process_time(), ev

    def _close(self, name: str, start: tuple, end: tuple) -> None:
        (t0, c0, ev0), (t1, c1, ev1) = start, end
        with self._lock:
            self._stats.setdefault(name, _Stat()).add((t1 - t0) / 1e9, c1 - c0)
            if len(self._events) < self.max_events:
                self._events.append({
                    "name": name, "ph": "X", "pid": 0,
                    "tid": threading.get_ident() & 0xFFFF,
                    "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                })
            if ev0 is not None:
                self._pending.append((name, t0, ev0, ev1))
            full = len(self._pending) >= self.max_events
        if full:
            self.resolve()

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        start = self._stamp()
        try:
            yield
        finally:
            self._close(name, start, self._stamp())

    def mark(self, name: "str | None" = None) -> None:
        """A boundary between consecutive phases: the span since the
        previous mark becomes a section called name, and the next phase
        starts here. A mark with name None, or the first one, only
        starts. Marks take one event a boundary where back-to-back
        sections take two; one thread at a time marks a profiler."""
        if not self.enabled:
            return
        now = self._stamp()
        prev, self._mark_from = self._mark_from, now
        if name is not None and prev is not None:
            self._close(name, prev, now)

    def resolve(self) -> None:
        """Read the device events of the sections ended so far into the
        stats and the trace. It waits for the last of them and for one
        anchor event after them: right after a synchronisation of the
        device, that is no wait."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        for *_, ev1 in pending:     # the streams of several threads
            ev1.synchronize()
        anchor = self._record()
        anchor.synchronize()
        anchor_ns = time.time_ns()
        with self._lock:
            for name, start, ev0, ev1 in pending:
                d0 = anchor_ns - ev0.elapsed_time(anchor) * 1e6
                dur_s = ev0.elapsed_time(ev1) / 1e3
                self._stats.setdefault(name, _Stat()).add_device(
                    dur_s, (d0 - start) / 1e9)
                if len(self._events) < self.max_events:
                    self._events.append({
                        "name": name, "ph": "X", "pid": 0, "tid": DEVICE_TID,
                        "ts": d0 / 1e3, "dur": dur_s * 1e6,
                    })

    def stats(self) -> Dict[str, _Stat]:
        self.resolve()
        with self._lock:
            return dict(self._stats)

    def summary(self) -> str:
        """Aligned table, one row a section by total host time: count, host
        total, mean, min, max, the process's CPU seconds; then the device's
        total and mean, and the mean lag of the device's start behind the
        host's ("-" without device spans)."""
        self.resolve()
        with self._lock:
            if not self._stats:
                return "(no sections recorded)"
            rows = [("section", "count", "total_s", "mean_ms", "min_ms", "max_ms",
                     "cpu_s", "device_s", "device_mean_ms", "lag_ms")]
            for name in sorted(self._stats, key=lambda n: -self._stats[n].total_s):
                s = self._stats[name]
                if s.count == 0:
                    rows.append((name, "0", "0.000") + ("-",) * 7)
                    continue
                dev = ("-", "-", "-")
                if s.device_count:
                    dev = (f"{s.device_s:.3f}",
                           f"{1e3 * s.device_s / s.device_count:.2f}",
                           f"{1e3 * s.lag_s / s.device_count:.2f}")
                rows.append((name, str(s.count), f"{s.total_s:.3f}",
                             f"{1e3 * s.total_s / s.count:.2f}",
                             f"{1e3 * s.min_s:.2f}", f"{1e3 * s.max_s:.2f}",
                             f"{s.cpu_s:.3f}") + dev)
            widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
            return "\n".join(
                "  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)

    def export_chrome_trace(self, path: str, *, native_events=None,
                            overwrite: bool = True) -> None:
        """Write the spans as a Chrome trace-event JSON file: a
        `process_name` metadata event, then one complete ("X") event per
        section entered on its thread's row, and with device spans a
        `thread_name` event and one complete event per section on the
        device's row (DEVICE_TID). `ts` is in microseconds on the
        time.time_ns() clock, that of torch.profiler's kernel timestamps
        (a torch.profiler JSON export writes them relative to its
        `baseTimeNanoseconds`).

        `native_events` merges events of the native core's flight recorder
        (comm.trace_events()) onto the same timeline: they keep their own
        pid, and their timestamps, CLOCK_MONOTONIC microseconds, are
        shifted by monotonic_offset_us. The caller's dicts are not changed.

        overwrite=False refuses to replace an existing file
        (FileExistsError)."""
        self.resolve()
        with self._lock:
            events = list(self._events)
        out = [{"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "python"}}]
        if any(e["tid"] == DEVICE_TID for e in events):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": DEVICE_TID, "args": {"name": "device"}})
        out += events
        for ev in native_events or []:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + self.monotonic_offset_us
            out.append(ev)
        with open(path, "w" if overwrite else "x") as f:
            json.dump({"traceEvents": out}, f)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._events.clear()
            self._pending.clear()
            self._mark_from = None
