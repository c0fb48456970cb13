"""Pure-Python 2-peer loopback ring all-reduce benchmark.

The port's copy of pccl_tpu/comm/pybench.py: two OS processes, one TCP
connection, full-duplex reduce-scatter + all-gather on fp32 numpy arrays,
i.e. an on-the-wire all-reduce with no native core, matching BASELINE.md
config 1 ("basic_reduce_test: fp32 allreduce, 2 loopback peers").

busbw for ring all-reduce = 2*(N-1)/N * bytes / time  (N=2 -> bytes/time).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np


def default_port() -> int:
    return int(os.environ.get("PCCLT_BENCH_PORT", "47911"))


def _send_all(sock: socket.socket, buf: memoryview) -> None:
    sock.sendall(buf)


def _recv_all(sock: socket.socket, buf: memoryview) -> None:
    got = 0
    n = len(buf)
    while got < n:
        r = sock.recv_into(buf[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _allreduce_2peer(sock: socket.socket, rank: int, x: np.ndarray) -> np.ndarray:
    """In-place sum all-reduce between 2 peers; returns reduced array."""
    n = x.size
    half = n // 2
    mine = slice(0, half) if rank == 0 else slice(half, n)       # chunk I own/reduce
    theirs = slice(half, n) if rank == 0 else slice(0, half)     # chunk peer owns
    rxbuf = np.empty(max(half, n - half), dtype=x.dtype)

    # reduce-scatter: send peer's chunk, receive mine, accumulate (full duplex)
    tx = threading.Thread(target=_send_all, args=(sock, memoryview(x[theirs]).cast("B")))
    tx.start()
    rxv = rxbuf[: (mine.stop - mine.start)]
    _recv_all(sock, memoryview(rxv).cast("B"))
    tx.join()
    x[mine] += rxv

    # all-gather: exchange reduced chunks
    tx = threading.Thread(target=_send_all, args=(sock, memoryview(x[mine]).cast("B")))
    tx.start()
    rxv = rxbuf[: (theirs.stop - theirs.start)]
    _recv_all(sock, memoryview(rxv).cast("B"))
    tx.join()
    x[theirs] = rxv
    return x


def _peer_main(rank: int, nbytes: int, iters: int, port: int, q) -> None:
    if rank == 0:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        srv.settimeout(30)
        sock, _ = srv.accept()
        srv.close()
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        for attempt in range(100):
            try:
                sock.connect(("127.0.0.1", port))
                break
            except OSError:
                if attempt == 99:
                    raise
                time.sleep(0.05)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    count = nbytes // 4
    x = np.full(count, float(rank + 1), dtype=np.float32)
    _allreduce_2peer(sock, rank, x.copy())  # warmup
    times = []
    for _ in range(iters):
        y = x.copy()
        t0 = time.perf_counter()
        y = _allreduce_2peer(sock, rank, y)
        times.append(time.perf_counter() - t0)
    assert abs(float(y[0]) - 3.0) < 1e-6, "allreduce result wrong"
    sock.close()
    if q is not None:
        q.put(times)


def run_allreduce_bench(nbytes: int = 64 << 20, iters: int = 10,
                        port: "int | None" = None) -> float:
    """Returns busbw in GB/s (median over iters). `port`: rank 0's
    listening port (default: PCCLT_BENCH_PORT, else 47911)."""
    port = default_port() if port is None else port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p1 = ctx.Process(target=_peer_main, args=(1, nbytes, iters, port, None))
    p1.start()
    try:
        _peer_main(0, nbytes, iters, port, q)
        times = q.get(timeout=60)
        p1.join(timeout=30)
    finally:
        if p1.is_alive():
            p1.terminate()
            p1.join(timeout=5)
    med = sorted(times)[len(times) // 2]
    return (nbytes / med) / 1e9
