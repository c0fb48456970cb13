"""Leveled stream logger for the port's Python code.

The native core logs through its own C++ logger under the same env var;
this module logs the Python side the same way, one line a message on
stderr: `[HH:MM:SS][LEVEL][py:TID] message`.

Env: PCCLT_LOG_LEVEL in {TRACE, DEBUG, INFO, WARN, ERROR, FATAL}; default
INFO (an unknown name keeps INFO). `fatal` logs and exits with code 1.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_LEVELS = {"TRACE": 0, "DEBUG": 1, "INFO": 2, "WARN": 3, "ERROR": 4, "FATAL": 5}
_level_name = os.environ.get("PCCLT_LOG_LEVEL", "INFO").upper()
_threshold = _LEVELS.get(_level_name, 2)
_lock = threading.Lock()


def set_level(name: str) -> None:
    global _threshold
    _threshold = _LEVELS.get(name.upper(), _threshold)


def _log(level: str, msg: str) -> None:
    if _LEVELS[level] < _threshold:
        return
    ts = time.strftime("%H:%M:%S", time.localtime())
    tid = threading.get_ident() % 100000
    with _lock:
        print(f"[{ts}][{level:>5}][py:{tid}] {msg}", file=sys.stderr, flush=True)


def trace(msg: str) -> None:
    _log("TRACE", msg)


def debug(msg: str) -> None:
    _log("DEBUG", msg)


def info(msg: str) -> None:
    _log("INFO", msg)


def warn(msg: str) -> None:
    _log("WARN", msg)


def error(msg: str) -> None:
    _log("ERROR", msg)


def fatal(msg: str) -> None:
    _log("FATAL", msg)
    raise SystemExit(1)
