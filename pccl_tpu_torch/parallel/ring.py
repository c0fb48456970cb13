"""Fault-tolerance policy for ring collectives on host arrays.

ConnectionLost/Aborted -> update_topology() -> retry with the surviving
world; TooFewPeers -> the caller is alone and the reduce is the identity.
"""

from __future__ import annotations

import numpy as np

from ..comm import (
    Communicator,
    ConnectionLostError,
    DataType,
    OperationAbortedError,
    QuantizationAlgorithm,
    ReduceOp,
    Result,
    TooFewPeersError,
)


def avg_all_reduce_with_retry(
        comm: Communicator, vec: np.ndarray, *, out: np.ndarray = None,
        quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE,
        quantized_dtype: DataType = DataType.UINT8,
        max_retries: int = 16) -> int:
    """AVG all-reduce `vec` over the ring, retrying across peer churn.
    With `out` the reduce runs out of place (the native ring then skips its
    in-place abort-restore backup) and `vec` is left untouched. Returns the
    world size that completed the reduce (1 = alone)."""
    recv = vec if out is None else out
    for _ in range(max_retries):
        try:
            info = comm.all_reduce(vec, recv, op=ReduceOp.AVG,
                                   quantization=quantization,
                                   quantized_dtype=quantized_dtype)
            return info.world_size
        except (ConnectionLostError, OperationAbortedError):
            # the world shrank mid-op; the native core restored recv from
            # the untouched send: adopt the survivor ring and go again
            comm.update_topology()
        except TooFewPeersError:
            if recv is not vec:
                np.copyto(recv, vec)  # alone: the reduction is the input
            return 1
    raise ConnectionLostError(
        Result.CONNECTION_LOST,
        f"all_reduce failed after {max_retries} retries")


# below this, windowing costs more in per-op overhead than it buys
_MIN_WINDOW_ELEMS = 1 << 20


def avg_all_reduce_windowed(
        comm: Communicator, vec: np.ndarray, *, windows: int = 1,
        out: np.ndarray = None,
        quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE,
        quantized_dtype: DataType = DataType.UINT8,
        max_retries: int = 16) -> int:
    """AVG all-reduce `vec`, split into `windows` concurrent tagged
    collectives (the native MultipleWithRetry policy). windows <= 1 or a
    small vec takes the single-op path. Returns the smallest world size any
    window completed with (1 = alone). On churn, completed windows stand and
    failed ones retry over the survivors. max_retries bounds only the
    single-op path."""
    windows = min(windows, max(1, vec.size // _MIN_WINDOW_ELEMS))
    if windows <= 1:
        return avg_all_reduce_with_retry(
            comm, vec, out=out, quantization=quantization,
            quantized_dtype=quantized_dtype, max_retries=max_retries)
    if out is not None:
        # the MultipleWithRetry band reduces in place: land the batch in out
        np.copyto(out, vec)
        vec = out
    views = np.array_split(vec, windows)  # contiguous views into vec
    try:
        infos = comm.all_reduce_multiple_with_retry(
            views, op=ReduceOp.AVG, quantization=quantization,
            quantized_dtype=quantized_dtype)
        return min(i.world_size for i in infos)
    except TooFewPeersError:
        return 1
