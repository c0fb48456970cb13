"""Section profiler for the training loops: named spans on the host clock,
aggregated per name, with an optional Chrome trace-event export.

The port of pccl_tpu/utils/profiler.py. A section measures host time only:
what runs on the card is counted only as far as the section waits for it,
so the examples place their sections where they already synchronise the
device.

    prof = Profiler()
    for step in range(steps):
        with prof.section("inner"):
            loss = float(step_fn(state, tokens, targets))
        with prof.section("outer/ring+sgd"):
            dl.outer_step(state.params)
    print(prof.summary())
    prof.export_chrome_trace("trace.json")   # chrome://tracing or perfetto

Sections nest; each records its whole (inclusive) duration, so summary()
rows do not add up across nesting levels. No dependencies; safe across
threads for disjoint section names.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


@dataclass
class Profiler:
    enabled: bool = True
    _stats: Dict[str, _Stat] = field(default_factory=dict)
    _events: List[dict] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _t0: float = field(default_factory=time.perf_counter)
    max_events: int = 100_000  # bound on the trace's events

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self._stats.setdefault(name, _Stat()).add(end - start)
                if len(self._events) < self.max_events:
                    self._events.append({
                        "name": name, "ph": "X", "pid": 0,
                        "tid": threading.get_ident() & 0xFFFF,
                        "ts": (start - self._t0) * 1e6,
                        "dur": (end - start) * 1e6,
                    })

    def stats(self) -> Dict[str, _Stat]:
        with self._lock:
            return dict(self._stats)

    def summary(self) -> str:
        """Aligned table, one row a section by total time: count, total,
        mean, min, max."""
        with self._lock:
            if not self._stats:
                return "(no sections recorded)"
            rows = [("section", "count", "total_s", "mean_ms", "min_ms", "max_ms")]
            for name in sorted(self._stats, key=lambda n: -self._stats[n].total_s):
                s = self._stats[name]
                if s.count == 0:
                    rows.append((name, "0", "0.000", "-", "-", "-"))
                    continue
                rows.append((name, str(s.count), f"{s.total_s:.3f}",
                             f"{1e3 * s.total_s / s.count:.2f}",
                             f"{1e3 * s.min_s:.2f}", f"{1e3 * s.max_s:.2f}"))
            widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
            return "\n".join(
                "  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)

    def export_chrome_trace(self, path: str, *, native_events=None,
                            overwrite: bool = True) -> None:
        """Write the spans as a Chrome trace-event JSON file: a
        `process_name` metadata event, then one complete ("X") event per
        section entered.

        `native_events` merges events of the native core's flight recorder
        onto the same timeline: they keep their own pid, and their
        timestamps (CLOCK_MONOTONIC microseconds, the clock of
        time.perf_counter on Linux) are shifted to this profiler's start,
        those before it clamped to 0. The port has no source of such
        events yet; the argument takes any list of trace-event dicts.

        overwrite=False refuses to replace an existing file
        (FileExistsError)."""
        with self._lock:
            events = list(self._events)
            t0_us = self._t0 * 1e6
        out = [{"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "python"}}] + events
        for ev in native_events or []:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = max(0.0, ev["ts"] - t0_us)
            out.append(ev)
        with open(path, "w" if overwrite else "x") as f:
            json.dump({"traceEvents": out}, f)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._events.clear()
            self._t0 = time.perf_counter()
