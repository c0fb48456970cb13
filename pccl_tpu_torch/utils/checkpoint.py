"""Checkpoints for the training loops: save a tree of tensors with its step,
and restore it into a template of the same structure.

The port of pccl_tpu/utils/checkpoint.py, with `torch.save` and
`torch.load(weights_only=True)` where the JAX package uses orbax. A restarted
cohort resumes from a checkpoint: every peer restores the same snapshot and
offers its revision to a fresh master, which accepts any first revision.
The shared-state sync stays the way a live cohort brings a joiner up to
date; a checkpoint covers the cold start, when no peer survives.

Layout: one directory per step, `<directory>/<step>/tree.pt`. A save writes
`<directory>/.<step>.<pid>.tmp/` and renames it into place, so a reader
never sees a half-written step; then all but the newest `keep` steps are
removed.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

_FILE = "tree.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _check(template: Any, got: Any, path: str = "tree") -> None:
    """Raise ValueError where `got` differs from `template` in structure,
    or in a tensor leaf's shape or dtype, or in a leaf's type."""
    if isinstance(template, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{path}: checkpoint holds {type(got).__name__}, "
                             "the template a tensor")
        if tuple(got.shape) != tuple(template.shape) or got.dtype != template.dtype:
            raise ValueError(f"{path}: checkpoint holds {got.dtype} "
                             f"{tuple(got.shape)}, the template {template.dtype} "
                             f"{tuple(template.shape)}")
    elif isinstance(template, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(template):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{path}: checkpoint holds {have}, the template "
                             f"{sorted(template)}")
        for k in template:
            _check(template[k], got[k], f"{path}[{k!r}]")
    elif isinstance(template, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(template):
            raise ValueError(f"{path}: checkpoint holds {type(got).__name__} "
                             f"{got!r:.60}, the template {len(template)} leaves")
        for i, (t, g) in enumerate(zip(template, got)):
            _check(t, g, f"{path}[{i}]")
    elif type(got) is not type(template):
        raise ValueError(f"{path}: checkpoint holds {type(got).__name__}, the "
                         f"template {type(template).__name__}")


def _place(template: Any, got: Any) -> Any:
    """`got` with each tensor leaf on its template leaf's device."""
    if isinstance(template, torch.Tensor):
        return got.to(template.device)
    if isinstance(template, dict):
        return {k: _place(template[k], got[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_place(t, g) for t, g in zip(template, got))
    return got


class Checkpointer:
    """Save and restore a tree (nested dicts, lists and tuples of tensors
    and Python scalars) with its step under `directory`, keeping the newest
    `keep` steps."""

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be at least 1")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def steps(self) -> list:
        """The saved steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> Path:
        """Write `tree` (copied to the host) as step `step`; returns the
        step's file."""
        final = self.directory / str(int(step))
        tmp = self.directory / f".{int(step)}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_to_cpu(tree), tmp / _FILE)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return final / _FILE

    def load(self, template: Any, step: Optional[int] = None) -> Any:
        """The saved tree of `step` (default: the newest) on the host,
        checked against `template`'s structure, shapes and dtypes. Raises
        FileNotFoundError when there is no such step, ValueError on any
        difference."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self.directory / str(int(step)) / _FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        got = torch.load(path, map_location="cpu", weights_only=True)
        _check(template, got)
        return got

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """load(), with each tensor leaf on its template leaf's device."""
        return _place(template, self.load(template, step))


class DilocoCheckpoint:
    """Save and restore the outer state of a Diloco
    (parallel/diloco.py): the outer fp32 vector, the outer momentum and the
    outer step.

        ck = DilocoCheckpoint("ckpt/", keep=2)
        dl = Diloco(comm, state.params, cfg)
        start = ck.maybe_restore(dl)    # 0 on a fresh start
        for outer in range(start, total):
            ...inner steps...
            dl.outer_step(state.params)
            ck.save(dl)

    A Diloco of a peer of several ranks (`shards=`) keeps its outer state
    on its lead: every rank calls save and maybe_restore, the lead saves
    and loads, and every rank gets the step to resume from; the caller
    then scatters the restored parameters with copy_outer_into, on every
    rank.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        self._ck = Checkpointer(directory, keep=keep)

    @staticmethod
    def _tree(diloco) -> dict:
        return {"outer": diloco.outer_vec, "momentum": diloco._momentum_vec,
                "step": torch.tensor(diloco.step, dtype=torch.int64)}

    def save(self, diloco) -> Optional[Path]:
        """Write the outer state; the file (None on a peer's other ranks)."""
        if not diloco.lead:
            return None
        return self._ck.save(diloco.step, self._tree(diloco))

    @torch.no_grad()
    def maybe_restore(self, diloco) -> int:
        """Restore the newest snapshot into `diloco` in place, on its
        device, if one exists. Returns the outer step to resume from (0
        when there is none)."""
        step = 0
        if diloco.lead and self._ck.latest_step() is not None:
            got = self._ck.load(self._tree(diloco))
            diloco.outer_vec.copy_(got["outer"])
            diloco._momentum_vec.copy_(got["momentum"])
            diloco.step = step = int(got["step"])
        if diloco.shards is not None:
            from ..parallel.mesh import share

            step, = share(diloco.shards.group, step)
        return step
