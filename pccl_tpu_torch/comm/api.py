"""High-level Python API over the native core.

The part of the pcclt surface the port's peers call: Communicator,
MasterNode, TensorInfo/SharedState, and the PcclError family. Collective
ops raise PcclError subclasses on peer churn and the caller retries after
update_topology().

The native core reads and writes host memory only: every collective
(all_reduce, all_gather, reduce_scatter, broadcast, all_to_all) takes host
ndarrays, and the callers stage CUDA tensors through pinned host buffers
(parallel/diloco.py, parallel/hierarchical.py; a pinned CPU tensor's
`.numpy()` is such an array). A shared-state entry of a CPU tensor shares its
storage (`TensorInfo.from_torch`, hashed by the core); one of a CUDA tensor
is hashed on the card (`TensorInfo.from_torch_device`: H1 computes the
`simple-tpu` digest, and the bytes go to the host only when the sync must
send or receive them).
"""

from __future__ import annotations

import contextlib
import ctypes
import enum
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from . import _native


class Result(enum.IntEnum):
    SUCCESS = 0
    INVALID_ARGUMENT = 1
    NOT_CONNECTED = 2
    CONNECTION_LOST = 3
    OPERATION_ABORTED = 4
    TOO_FEW_PEERS = 5
    DUPLICATE_TAG = 6
    KICKED = 7
    MASTER_UNREACHABLE = 8
    INTERNAL_ERROR = 9
    CONTENT_MISMATCH = 10
    PENDING_ASYNC_OPS = 11
    INVALID_USAGE = 12


class DataType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    UINT64 = 6
    INT64 = 7
    FLOAT16 = 8
    BFLOAT16 = 9
    FLOAT32 = 10
    FLOAT64 = 11


class DeviceType(enum.IntEnum):
    # the C enum (pcclt.h). The core only labels entries with it; a CUDA
    # tensor's entry takes the label the JAX package gives accelerator
    # entries, TPU, since the enum has no CUDA member
    HOST = 0
    TPU = 1


class ReduceOp(enum.IntEnum):
    SUM = 0
    AVG = 1
    PROD = 2
    MAX = 3
    MIN = 4


class QuantizationAlgorithm(enum.IntEnum):
    NONE = 0
    MIN_MAX = 1
    ZERO_POINT_SCALE = 2


class SharedStateSyncStrategy(enum.IntEnum):
    ENFORCE_POPULAR = 0
    RECEIVE_ONLY = 1
    SEND_ONLY = 2


class Attribute(enum.IntEnum):
    GLOBAL_WORLD_SIZE = 0
    PEER_GROUP_WORLD_SIZE = 1
    NUM_DISTINCT_PEER_GROUPS = 2
    LARGEST_PEER_GROUP_WORLD_SIZE = 3
    MASTER_EPOCH = 4
    RECONNECT_COUNT = 5
    SHARED_STATE_REVISION = 6


_NP_TO_DTYPE = {
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint16): DataType.UINT16,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.uint32): DataType.UINT32,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.uint64): DataType.UINT64,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
}


_DTYPE_ITEMSIZE = {
    DataType.UINT8: 1, DataType.INT8: 1,
    DataType.UINT16: 2, DataType.INT16: 2,
    DataType.UINT32: 4, DataType.INT32: 4,
    DataType.UINT64: 8, DataType.INT64: 8,
    DataType.FLOAT16: 2, DataType.BFLOAT16: 2,
    DataType.FLOAT32: 4, DataType.FLOAT64: 8,
}


def _np_dtype_of(arr: np.ndarray) -> DataType:
    try:
        return _NP_TO_DTYPE[arr.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {arr.dtype}") from None


# torch dtype names (resolved by name, so this module imports no torch)
_TORCH_TO_DTYPE = {
    "uint8": DataType.UINT8, "int8": DataType.INT8,
    "uint16": DataType.UINT16, "int16": DataType.INT16,
    "uint32": DataType.UINT32, "int32": DataType.INT32,
    "uint64": DataType.UINT64, "int64": DataType.INT64,
    "float16": DataType.FLOAT16, "bfloat16": DataType.BFLOAT16,
    "float32": DataType.FLOAT32, "float64": DataType.FLOAT64,
}


def _torch_dtype_of(tensor) -> DataType:
    name = str(tensor.dtype).removeprefix("torch.")
    try:
        return _TORCH_TO_DTYPE[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {tensor.dtype}") from None


def _host_view(host) -> np.ndarray:
    """numpy view of a CPU tensor's storage; bf16, which numpy lacks, is
    viewed as int16 (the entry's DataType says what the bytes are)."""
    import torch

    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return host.numpy()


# ---------------------------------------------------------------- exceptions

class PcclError(RuntimeError):
    """Base error; .result carries the native status code."""

    def __init__(self, result: Result, what: str = ""):
        self.result = Result(result)
        super().__init__(f"{self.result.name}{': ' + what if what else ''}")


class ConnectionLostError(PcclError):
    """A peer died mid-op; re-establish with update_topology() and retry."""


class OperationAbortedError(PcclError):
    """The op was aborted group-wide; retry after update_topology()."""


class TooFewPeersError(PcclError):
    """world < 2 — wait for peers to join, then retry."""


class KickedError(PcclError):
    """The master kicked this peer (protocol violation or state mismatch)."""


class MasterUnreachableError(PcclError):
    pass


def _check(code: int, what: str = "") -> None:
    if code == Result.SUCCESS:
        return
    r = Result(code)
    cls = {
        Result.CONNECTION_LOST: ConnectionLostError,
        Result.OPERATION_ABORTED: OperationAbortedError,
        Result.TOO_FEW_PEERS: TooFewPeersError,
        Result.KICKED: KickedError,
        Result.MASTER_UNREACHABLE: MasterUnreachableError,
    }.get(r, PcclError)
    raise cls(r, what)


# ---------------------------------------------------- registered shm buffers

def shm_ndarray(shape, dtype=np.float32) -> np.ndarray:
    """A numpy array in a registered shared-memory region (pccltShmAlloc).
    A collective whose buffers lie in a registered region takes the core's
    same-host zero-copy path: a local peer maps the region and reduces
    straight out of it. Any array works with every op; this one is for
    large staging buffers (DiLoCo's outer-step vector).

    The region is a memfd, so host memory bounds it, not /dev/shm's size.
    It is freed when the array and every view of it are gone."""
    lib = _native.load()
    shape = (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)
    nbytes = max(1, int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize)
    ptr = ctypes.c_void_p()
    _check(lib.pccltShmAlloc(nbytes, ctypes.byref(ptr)), "shm alloc")
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    weakref.finalize(buf, lib.pccltShmFree, ctypes.c_void_p(ptr.value))
    return np.ndarray(shape, dtype=dtype, buffer=buf)


# ---------------------------------------------------- flight-recorder trace

def trace_enable(on: bool = True) -> None:
    """Switch the native flight recorder's event capture on or off
    (process-global). The counters of Communicator.stats() are always on;
    this gates only the event ring behind trace_events() and trace_dump().
    PCCLT_TRACE=path in the environment turns capture on at load and dumps
    at exit."""
    _check(_native.load().pccltTraceEnable(1 if on else 0), "trace enable")


def trace_clear() -> None:
    """Drop every captured event (isolates phases that share a process)."""
    _check(_native.load().pccltTraceClear(), "trace clear")


def trace_dump(path: str) -> None:
    """Write the event ring as Chrome trace-event JSON. Timestamps are
    CLOCK_MONOTONIC microseconds; utils/profiler.Profiler's export shifts
    them onto its sections' clock."""
    _check(_native.load().pccltTraceDump(path.encode()), "trace dump")


def trace_events() -> list:
    """The recorder's current events as Chrome trace-event dicts (the
    parsed form of trace_dump's output)."""
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        trace_dump(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def netem_inject(endpoint: str, spec: str) -> None:
    """Arm a time-scripted fault schedule on the wire-emulation edge toward
    `endpoint` ("ip:port"), offsets relative to now, e.g.
    "degrade@t=0s:40mbit/8s", "flap@t=1s:200msx5" or "blackhole@t=0s:2s"
    (';' separates faults). An empty spec disarms the edge."""
    _check(_native.load().pccltNetemInject(endpoint.encode(), spec.encode()),
           "netem inject")


def build_info() -> str:
    """The native core's build string (compiler, flags, features)."""
    return _native.load().pccltGetBuildInfo().decode()


# ---------------------------------------------------------------- master

class MasterNode:
    """Standalone orchestration master: control plane only, bulk data never
    flows through it. ``journal_path`` enables master HA (a restarted master
    on the same journal resumes the world under a bumped epoch); ``None``
    falls back to the ``PCCLT_MASTER_JOURNAL`` env var."""

    def __init__(self, listen_address: str = "0.0.0.0", port: int = 48501,
                 journal_path: Optional[str] = None):
        self._lib = _native.load()
        handle = ctypes.c_void_p()
        _check(self._lib.pccltCreateMasterEx(
            listen_address.encode(), port,
            journal_path.encode() if journal_path is not None else None,
            ctypes.byref(handle)), "create master")
        self._h = handle

    def run(self) -> None:
        _check(self._lib.pccltRunMaster(self._h), "run master")

    @property
    def port(self) -> int:
        return int(self._lib.pccltMasterPort(self._h))

    @property
    def epoch(self) -> int:
        """1 fresh (or journal-less), +1 on every journaled restart."""
        return int(self._lib.pccltMasterEpoch(self._h))

    @property
    def metrics_port(self) -> int:
        """Port of the plain-HTTP /metrics (Prometheus text) and /health
        (JSON) endpoint, which PCCLT_MASTER_METRICS_PORT enables ("0": a
        port the kernel picks). 0 while disabled or before run()."""
        return int(self._lib.pccltMasterMetricsPort(self._h))

    def health(self) -> dict:
        """The master's fleet-health document (the /health JSON: epoch,
        world, client and limbo counts, each peer's digest freshness, each
        edge's throughput and stall with straggler flags), read from the
        native state, so the HTTP endpoint may be off. Peers appear once
        they push telemetry digests (PCCLT_TELEMETRY_PUSH_MS)."""
        import json

        need = ctypes.c_uint64()
        _check(self._lib.pccltMasterGetHealth(self._h, None, 0,
                                              ctypes.byref(need)), "health")
        # the document can grow between the sizing call and the copy (live
        # digests); the copy reports the true length again, so retry until
        # it fits
        for _ in range(8):
            cap = need.value + 256
            buf = ctypes.create_string_buffer(cap)
            _check(self._lib.pccltMasterGetHealth(self._h, buf, cap,
                                                  ctypes.byref(need)), "health")
            if need.value < cap:
                return json.loads(buf.value.decode())
        raise PcclError(Result.INTERNAL_ERROR,
                        "health document kept outgrowing its buffer")

    def interrupt(self) -> None:
        _check(self._lib.pccltInterruptMaster(self._h))

    def await_termination(self) -> None:
        _check(self._lib.pccltMasterAwaitTermination(self._h))

    def destroy(self) -> None:
        if self._h:
            self._lib.pccltDestroyMaster(self._h)
            self._h = None

    def __enter__(self) -> "MasterNode":
        self.run()
        return self

    def __exit__(self, *exc) -> None:
        self.interrupt()
        self.destroy()

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


# ---------------------------------------------------------------- tensors

@dataclass
class TensorInfo:
    """One named shared-state entry over a host buffer the native core
    reads and writes in place. Keeps the buffer alive."""

    name: str
    data: np.ndarray
    dtype: DataType
    device: DeviceType = DeviceType.HOST
    allow_content_inequality: bool = False
    updated: bool = False   # set by sync_shared_state: content was received
    _source: Any = field(default=None, repr=False)   # the tensor given
    _host: Any = field(default=None, repr=False)     # CPU tensor behind data
    # device-hash entries (from_torch_device): the digest computed on the
    # card, and the callback that stages the bytes when the sync sends them
    _precomputed_hash: Optional[int] = field(default=None, repr=False)
    _materialize_cb: Any = field(default=None, repr=False)

    @staticmethod
    def from_numpy(name: str, arr: np.ndarray,
                   allow_content_inequality: bool = False) -> "TensorInfo":
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("array must be C-contiguous")
        if not arr.flags["WRITEABLE"]:
            raise ValueError("array must be writable (sync writes into it)")
        return TensorInfo(name, arr, _np_dtype_of(arr), DeviceType.HOST,
                          allow_content_inequality)

    @staticmethod
    def from_torch(name: str, tensor,
                   allow_content_inequality: bool = False) -> "TensorInfo":
        """A CPU tensor's storage, shared with the entry (sync writes land
        in the tensor; it must be contiguous), hashed by the core on the
        host. A CUDA tensor is refused: use from_torch_device."""
        src = tensor.detach()
        if src.device.type != "cpu":
            raise ValueError("torch tensor must be on CPU (a CUDA tensor's "
                             "entry is TensorInfo.from_torch_device)")
        if not src.is_contiguous():
            raise ValueError("a CPU tensor must be contiguous (sync "
                             "writes into its storage)")
        return TensorInfo(name, _host_view(src), _torch_dtype_of(src),
                          DeviceType.HOST, allow_content_inequality,
                          _source=tensor, _host=src)

    @staticmethod
    def from_torch_device(name: str, tensor,
                          allow_content_inequality: bool = False
                          ) -> "TensorInfo":
        """An entry whose `simple-tpu` digest is computed where the tensor
        lies (H1 on a CUDA card: 8 bytes cross to the host). The bytes are
        staged into a pageable host buffer only when the sync needs them:
        when this peer serves the entry (the core calls the materialize
        callback, once per sync) or receives it. A clean sync of N bytes
        thus moves none of them.

        Needs PCCLT_SS_HASH=simple-tpu, on every peer of the group; raises
        otherwise, since a group whose peers hash differently would see
        phantom drift at every sync. After the sync, torch_value() is the
        authoritative content."""
        if os.environ.get("PCCLT_SS_HASH") != "simple-tpu":
            raise RuntimeError(
                "TensorInfo.from_torch_device needs PCCLT_SS_HASH=simple-tpu "
                "(every peer of the group must hash with the type the card "
                "computes); set it, or use from_torch for staged entries")
        import torch

        from ..ops.hashing import torch_simplehash_device

        src = tensor.detach()
        # pageable and never written until the sync needs the bytes, so no
        # page of it is resident on a clean sync (as the JAX package's
        # np.empty); a D2H copy into it is synchronous
        host = torch.empty(src.shape, dtype=src.dtype)
        ti = TensorInfo(name, _host_view(host), _torch_dtype_of(src),
                        DeviceType.TPU, allow_content_inequality,
                        _source=tensor, _host=host)
        if not allow_content_inequality:
            ti._precomputed_hash = torch_simplehash_device(src)

        def _materialize(_ctx):
            # called from a native serving thread (ctypes takes the GIL):
            # one D2H copy, which returns only once the bytes have landed
            ctx = torch.cuda.device(src.device) if src.device.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                host.copy_(src)

        ti._materialize_cb = _native.MaterializeFn(_materialize)
        return ti

    def torch_value(self):
        """The entry's content after a sync, on the source tensor's
        device: the source tensor itself (the object given to the
        factory) when the sync wrote nothing, else the received bytes
        (copied to the card for a CUDA source)."""
        if self._source is None:
            raise ValueError(f"entry {self.name!r} has no torch source")
        if not self.updated:
            return self._source
        return self._host.to(self._source.device)

    def _as_c(self, keepalive: list) -> _native.TensorInfoC:
        name_b = self.name.encode()
        keepalive.append(name_b)
        has_h = self._precomputed_hash is not None
        if self._materialize_cb is not None:
            keepalive.append(self._materialize_cb)
        return _native.TensorInfoC(
            name=name_b,
            data=self.data.ctypes.data_as(ctypes.c_void_p),
            count=self.data.size,
            dtype=int(self.dtype),
            device=int(self.device),
            allow_content_inequality=1 if self.allow_content_inequality else 0,
            precomputed_hash=self._precomputed_hash if has_h else 0,
            has_precomputed_hash=1 if has_h else 0,
            materialize=self._materialize_cb if self._materialize_cb is not None
            else _native.MaterializeFn(),
            materialize_ctx=None,
            updated=0,
        )


@dataclass
class SharedState:
    """Revisioned named tensor set, synced bit-identically across peers."""

    infos: Sequence[TensorInfo]
    revision: int = 0


@dataclass
class SharedStateSyncInfo:
    tx_bytes: int
    rx_bytes: int
    revision: int


@dataclass
class ReduceInfo:
    tx_bytes: int
    rx_bytes: int
    world_size: int


@dataclass
class ReduceDescriptor:
    """Per-op config: wire tag, reduction, optional on-the-wire
    quantization."""

    tag: int = 0
    op: ReduceOp = ReduceOp.SUM
    quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE
    quantized_dtype: DataType = DataType.UINT8

    def _as_c(self) -> _native.ReduceDescriptor:
        return _native.ReduceDescriptor(
            tag=self.tag, op=int(self.op), quant_algo=int(self.quantization),
            quant_dtype=int(self.quantized_dtype))


class AsyncReduceHandle:
    """Handle for an in-flight all-reduce. Holds buffer references so the
    native op never outlives its memory."""

    def __init__(self, comm: "Communicator", tag: int, keepalive: tuple):
        self._comm = comm
        self._tag = tag
        self._keepalive = keepalive
        self._done = False

    def wait(self) -> ReduceInfo:
        if self._done:
            raise PcclError(Result.INVALID_USAGE, "handle already awaited")
        self._done = True
        info = _native.ReduceInfo()
        code = self._comm._lib.pccltAwaitAsyncReduce(
            self._comm._h, self._tag, ctypes.byref(info))
        self._keepalive = ()
        _check(code, f"await reduce tag={self._tag}")
        return ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size)


# ---------------------------------------------------------------- communicator

class Communicator:
    """One peer of the collective.

        comm = Communicator("10.0.0.1", 48501)
        comm.connect()
        while training:
            comm.update_topology()          # admit joiners / adopt new ring
            try:
                comm.all_reduce(vec, op=ReduceOp.AVG)
            except (ConnectionLostError, OperationAbortedError):
                continue                    # world shrank; retry
    """

    # auto tags live in a high band, disjoint from the blocking default 0,
    # small user tags and the MultipleWithRetry band
    _AUTO_TAG_BASE = 1 << 32
    _RETRY_TAG_BASE = 1 << 16

    def __init__(self, master_ip: str, master_port: int = 48501, *,
                 peer_group: int = 0, advertised_ip: Optional[str] = None,
                 p2p_port: int = 0, ss_port: int = 0, bench_port: int = 0,
                 p2p_connection_pool_size: int = 1,
                 reconnect_attempts: Optional[int] = None,
                 reconnect_backoff_ms: int = 0,
                 reconnect_backoff_cap_ms: int = 0):
        self._lib = _native.load()
        params = _native.CommCreateParams(
            master_ip=master_ip.encode(),
            master_port=master_port,
            peer_group=peer_group,
            advertised_ip=advertised_ip.encode() if advertised_ip else None,
            p2p_port=p2p_port,
            ss_port=ss_port,
            bench_port=bench_port,
            p2p_connection_pool_size=p2p_connection_pool_size,
            reconnect_attempts=(-1 if reconnect_attempts is None
                                else reconnect_attempts),
            reconnect_backoff_ms=reconnect_backoff_ms,
            reconnect_backoff_cap_ms=reconnect_backoff_cap_ms,
        )
        handle = ctypes.c_void_p()
        _check(self._lib.pccltCreateCommunicator(ctypes.byref(params),
                                                 ctypes.byref(handle)))
        self._h = handle
        self._tag_lock = threading.Lock()
        self._next_tag = self._AUTO_TAG_BASE

    # -- lifecycle --

    def connect(self) -> None:
        _check(self._lib.pccltConnect(self._h), "connect")

    def destroy(self) -> None:
        if self._h:
            self._lib.pccltDestroyCommunicator(self._h)
            self._h = None

    def __enter__(self) -> "Communicator":
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass

    # -- membership / topology --

    def get_attribute(self, attr: Attribute) -> int:
        out = ctypes.c_int64()
        _check(self._lib.pccltGetAttribute(self._h, int(attr), ctypes.byref(out)))
        return out.value

    @property
    def world_size(self) -> int:
        return self.get_attribute(Attribute.PEER_GROUP_WORLD_SIZE)

    @property
    def global_world_size(self) -> int:
        return self.get_attribute(Attribute.GLOBAL_WORLD_SIZE)

    @property
    def num_peer_groups(self) -> int:
        return self.get_attribute(Attribute.NUM_DISTINCT_PEER_GROUPS)

    @property
    def largest_peer_group(self) -> int:
        """The largest group's world size; with num_peer_groups, the grid
        fullness check: global == num_groups * largest."""
        return self.get_attribute(Attribute.LARGEST_PEER_GROUP_WORLD_SIZE)

    @property
    def master_epoch(self) -> int:
        """The master epoch seen at welcome or the last session resume; a
        journaled master bumps it at every restart."""
        return self.get_attribute(Attribute.MASTER_EPOCH)

    @property
    def reconnect_count(self) -> int:
        """How often this communicator resumed its master session."""
        return self.get_attribute(Attribute.RECONNECT_COUNT)

    @property
    def shared_state_revision(self) -> int:
        """The last shared-state revision known complete group-wide. If a
        sync raised and this already covers its revision, the round ended
        just before the fault: skip the retry."""
        return self.get_attribute(Attribute.SHARED_STATE_REVISION)

    def update_topology(self) -> None:
        _check(self._lib.pccltUpdateTopology(self._h), "update topology")

    def are_peers_pending(self) -> bool:
        out = ctypes.c_int()
        _check(self._lib.pccltArePeersPending(self._h, ctypes.byref(out)))
        return out.value != 0

    def optimize_topology(self) -> None:
        """Probe the bandwidth between the group's peers and adopt the ring
        the master solves for (a later call may adopt its improved
        solution)."""
        _check(self._lib.pccltOptimizeTopology(self._h), "optimize topology")

    # -- telemetry --

    _EDGE_FIELDS = tuple(name for name, _ in _native.EdgeStats._fields_
                         if name != "endpoint")

    def stats(self) -> dict:
        """This communicator's counters, monotonic since connect:
        {"counters": {collectives_ok, ...}, "edges": {"ip:port": {tx_bytes,
        rx_bytes, tx_frames, ...}}}, an edge keyed by the remote peer's
        advertised p2p endpoint."""
        cs = _native.CommStats()
        _check(self._lib.pccltCommGetStats(self._h, ctypes.byref(cs)), "stats")
        counters = {name: int(getattr(cs, name)) for name, _ in cs._fields_}
        n = ctypes.c_uint64()
        _check(self._lib.pccltCommGetEdgeStats(self._h, None, 0,
                                               ctypes.byref(n)), "edge stats")
        edges = {}
        if n.value:
            buf = (_native.EdgeStats * n.value)()
            _check(self._lib.pccltCommGetEdgeStats(self._h, buf, n.value,
                                                   ctypes.byref(n)),
                   "edge stats")
            for e in buf[:min(n.value, len(buf))]:
                edges[e.endpoint.decode()] = {
                    k: int(getattr(e, k)) for k in self._EDGE_FIELDS}
        return {"counters": counters, "edges": edges}

    def trace_events(self) -> list:
        """The flight recorder's events (process-global: every
        communicator and master of the process feeds one ring); see the
        module function trace_events."""
        return trace_events()

    # -- collectives --

    def _auto_tag(self) -> int:
        with self._tag_lock:
            t = self._next_tag
            self._next_tag += 1
            return t

    @staticmethod
    def _buffers(send, recv):
        # the buffer the native core writes into must be the caller's memory:
        # a silent ascontiguousarray copy would discard the result
        if recv is None:
            if not isinstance(send, np.ndarray) or not send.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    "in-place all_reduce requires a C-contiguous ndarray "
                    "(pass a separate contiguous recv buffer otherwise)")
            if not send.flags["WRITEABLE"]:
                raise ValueError("in-place all_reduce requires a writable array")
            return send, send
        if not isinstance(recv, np.ndarray) or not recv.flags["C_CONTIGUOUS"]:
            raise ValueError("recv must be a C-contiguous ndarray")
        if not recv.flags["WRITEABLE"]:
            raise ValueError("recv must be writable")
        send = np.ascontiguousarray(send)  # send is read-only; a copy is fine
        if recv.dtype != send.dtype or recv.size != send.size:
            raise ValueError("recv buffer must match send dtype/size")
        return send, recv

    def all_reduce(self, send, recv=None, *, op: ReduceOp = ReduceOp.SUM,
                   tag: int = 0,
                   quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE,
                   quantized_dtype: DataType = DataType.UINT8,
                   dtype: Optional[DataType] = None) -> ReduceInfo:
        """Blocking ring all-reduce; recv=None reduces in place. Every group
        member must call with the same tag. Raises ConnectionLostError /
        OperationAbortedError on peer churn.

        dtype overrides the wire dtype numpy cannot express: BFLOAT16 with
        the int16 (or uint16) arrays that hold bf16 bits (`_host_view` of a
        bf16 tensor). Its element size must be the arrays'."""
        send, recv = self._buffers(send, recv)
        desc = ReduceDescriptor(tag, op, quantization, quantized_dtype)._as_c()
        info = _native.ReduceInfo()
        wire = _np_dtype_of(send) if dtype is None else DataType(dtype)
        if _DTYPE_ITEMSIZE[wire] != send.dtype.itemsize:
            # the element count crosses the C API, not bytes: a mismatched
            # override would reduce a fraction of the buffer, or past it
            raise ValueError(
                f"wire dtype {wire.name} is {_DTYPE_ITEMSIZE[wire]} "
                f"bytes/elem but the arrays hold {send.dtype.itemsize}-byte "
                f"elements")
        code = self._lib.pccltAllReduce(
            self._h, send.ctypes.data_as(ctypes.c_void_p),
            recv.ctypes.data_as(ctypes.c_void_p), send.size,
            int(wire), ctypes.byref(desc), ctypes.byref(info))
        _check(code, "all_reduce")
        return ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size)

    @staticmethod
    def _recv_buffer(recv, send: np.ndarray, capacity: int) -> np.ndarray:
        """Check a caller's recv buffer for a collective that writes up to
        `capacity` elements of send's dtype into it."""
        if recv.dtype != send.dtype:
            raise ValueError(f"recv dtype {recv.dtype} != send {send.dtype}")
        if not recv.flags["C_CONTIGUOUS"] or not recv.flags["WRITEABLE"]:
            raise ValueError("recv must be writable and C-contiguous")
        if recv.size < capacity:
            raise ValueError(f"recv capacity {recv.size} < {capacity}")
        return recv

    def all_gather(self, send, recv=None, *, tag: int = 0) -> tuple:
        """Ring all-gather: every peer contributes `send`; returns (recv,
        ReduceInfo), where segment i is the contribution of the peer at
        sorted-uuid position i (this peer's is `gather_slot`). recv=None
        allocates (world_size, *send.shape); a caller's recv must be
        writable, C-contiguous, send's dtype, with capacity >= world_size *
        send.size. The core checks the capacity again against the world at
        commence, so a joiner admitted meanwhile aborts the op rather than
        overflow it. Alone, the own segment lands at slot 0."""
        send = np.ascontiguousarray(send)
        world = self.world_size
        if recv is None:
            recv = np.empty((world,) + send.shape, dtype=send.dtype)
        self._recv_buffer(recv, send, world * send.size)
        if world <= 1:
            np.copyto(recv.reshape(-1)[:send.size].reshape(send.shape), send)
            return recv, ReduceInfo(0, 0, 1)
        info = _native.ReduceInfo()
        code = self._lib.pccltAllGather(
            self._h, send.ctypes.data_as(ctypes.c_void_p),
            recv.ctypes.data_as(ctypes.c_void_p), send.size, recv.size,
            int(_np_dtype_of(send)), tag, ctypes.byref(info))
        _check(code, "all_gather")
        return recv, ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size)

    @property
    def gather_slot(self) -> int:
        """This peer's segment index in all_gather's output and its slot
        for broadcast's root and all_to_all's blocks: its position among
        the ring's sorted peer uuids (query again after churn)."""
        slot = ctypes.c_uint64()
        _check(self._lib.pccltGatherSlot(self._h, ctypes.byref(slot)),
               "gather_slot")
        return int(slot.value)

    def reduce_scatter(self, send, recv=None, *, tag: int = 0,
                       quantization: QuantizationAlgorithm =
                       QuantizationAlgorithm.NONE,
                       quantized_dtype: DataType = DataType.UINT8) -> tuple:
        """Ring reduce-scatter: the group SUM of `send`, of which each peer
        keeps its own contiguous chunk. Returns (chunk, offset,
        ReduceInfo): chunk is a view of recv and chunk[i] == sum of
        send[offset + i]. Chunks follow ring rank, so (offset, count) can
        change across churn: use the returned values. recv=None allocates
        ceil(count / world) elements; a caller's recv must be writable,
        C-contiguous, send's dtype, with at least that capacity (checked
        again by the core against the world at commence). Alone, the chunk
        is the whole of send at offset 0."""
        send = np.ascontiguousarray(send)
        world = self.world_size
        if recv is None:
            recv = np.empty(max(1, -(-send.size // max(world, 1))),
                            dtype=send.dtype)
        if world <= 1:
            self._recv_buffer(recv, send, send.size)
            np.copyto(recv.reshape(-1)[:send.size], send.reshape(-1))
            return recv.reshape(-1)[:send.size], 0, ReduceInfo(0, 0, 1)
        # its capacity is checked by the core, against the world at commence
        self._recv_buffer(recv, send, 0)
        desc = ReduceDescriptor(tag, ReduceOp.SUM, quantization,
                                quantized_dtype)._as_c()
        info = _native.ReduceInfo()
        off = ctypes.c_uint64()
        cnt = ctypes.c_uint64()
        code = self._lib.pccltReduceScatter(
            self._h, send.ctypes.data_as(ctypes.c_void_p),
            recv.ctypes.data_as(ctypes.c_void_p), send.size, recv.size,
            int(_np_dtype_of(send)), ctypes.byref(desc), ctypes.byref(off),
            ctypes.byref(cnt), ctypes.byref(info))
        _check(code, "reduce_scatter")
        return (recv.reshape(-1)[:int(cnt.value)], int(off.value),
                ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size))

    def broadcast(self, buf, *, root: int, tag: int = 0,
                  quantization: QuantizationAlgorithm =
                  QuantizationAlgorithm.NONE,
                  quantized_dtype: DataType = DataType.UINT8) -> ReduceInfo:
        """In-place broadcast from the peer whose gather_slot is `root`;
        every peer must pass the same root (a mismatch is a parameter
        disagreement, and the minority is kicked). On return buf holds the
        root's bytes on every peer. Alone, buf is left as it is."""
        if not isinstance(buf, np.ndarray) or not buf.flags["C_CONTIGUOUS"] \
                or not buf.flags["WRITEABLE"]:
            raise ValueError("broadcast buffer must be a writable "
                             "C-contiguous ndarray (updated in place)")
        if self.world_size <= 1:
            return ReduceInfo(0, 0, 1)
        desc = ReduceDescriptor(tag, ReduceOp.SUM, quantization,
                                quantized_dtype)._as_c()
        info = _native.ReduceInfo()
        code = self._lib.pccltBroadcast(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.size,
            int(root), int(_np_dtype_of(buf)), ctypes.byref(desc),
            ctypes.byref(info))
        _check(code, "broadcast")
        return ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size)

    def all_to_all(self, send, recv=None, *, tag: int = 0,
                   quantization: QuantizationAlgorithm =
                   QuantizationAlgorithm.NONE,
                   quantized_dtype: DataType = DataType.UINT8) -> tuple:
        """Personalized exchange: `send` is world_size equal blocks in slot
        order; block j goes to the peer of slot j, and recv block i is the
        block the peer of slot i addressed to this one. send.size must be
        divisible by world_size. recv=None allocates send's shape; a
        caller's recv must be writable, C-contiguous, send's dtype, with
        capacity >= send.size. Returns (recv, ReduceInfo). Alone, recv is a
        copy of send."""
        send = np.ascontiguousarray(send)
        world = self.world_size
        if recv is None:
            recv = np.empty(send.shape, dtype=send.dtype)
        self._recv_buffer(recv, send, send.size)
        if world <= 1:
            np.copyto(recv.reshape(-1)[:send.size], send.reshape(-1))
            return recv, ReduceInfo(0, 0, 1)
        if send.size % world:
            raise ValueError(f"send size {send.size} not divisible by "
                             f"world {world}")
        desc = ReduceDescriptor(tag, ReduceOp.SUM, quantization,
                                quantized_dtype)._as_c()
        info = _native.ReduceInfo()
        code = self._lib.pccltAllToAll(
            self._h, send.ctypes.data_as(ctypes.c_void_p),
            recv.ctypes.data_as(ctypes.c_void_p), send.size // world,
            recv.size, int(_np_dtype_of(send)), ctypes.byref(desc),
            ctypes.byref(info))
        _check(code, "all_to_all")
        return recv, ReduceInfo(info.tx_bytes, info.rx_bytes, info.world_size)

    def all_reduce_async(self, send, recv=None, *, op: ReduceOp = ReduceOp.SUM,
                         tag: Optional[int] = None,
                         quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE,
                         quantized_dtype: DataType = DataType.UINT8) -> AsyncReduceHandle:
        """Async variant. tag=None auto-allocates a locally increasing tag;
        under dynamic membership pass the same explicit tag on every peer."""
        send, recv = self._buffers(send, recv)
        tag = tag if tag is not None else self._auto_tag()
        desc = ReduceDescriptor(tag, op, quantization, quantized_dtype)._as_c()
        code = self._lib.pccltAllReduceAsync(
            self._h, send.ctypes.data_as(ctypes.c_void_p),
            recv.ctypes.data_as(ctypes.c_void_p), send.size,
            int(_np_dtype_of(send)), ctypes.byref(desc))
        _check(code, "all_reduce_async")
        return AsyncReduceHandle(self, tag, (send, recv))

    def all_reduce_multiple_with_retry(self, tensors: Sequence,
                                       *, op: ReduceOp = ReduceOp.SUM,
                                       quantization: QuantizationAlgorithm =
                                       QuantizationAlgorithm.NONE,
                                       quantized_dtype: DataType = DataType.UINT8,
                                       ) -> list[ReduceInfo]:
        """Launch one in-place reduce per array, retrying as the world
        shrinks until all succeed."""
        for t in tensors:
            if not isinstance(t, np.ndarray) or not t.flags["C_CONTIGUOUS"] \
                    or not t.flags["WRITEABLE"]:
                raise ValueError("tensors must be writable C-contiguous ndarrays "
                                 "(reduced in place)")
        arrs = list(tensors)
        if not arrs:
            return []
        dt = _np_dtype_of(arrs[0])
        if any(_np_dtype_of(a) != dt for a in arrs):
            raise ValueError("all tensors must share a dtype")
        n = len(arrs)
        ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
        counts = (ctypes.c_uint64 * n)(*[a.size for a in arrs])
        descs = (_native.ReduceDescriptor * n)()
        for i in range(n):
            # deterministic tags (reserved band + index): peers match ops
            # by tag, so a late joiner must not drift from incumbents
            descs[i] = ReduceDescriptor(self._RETRY_TAG_BASE + i, op,
                                        quantization, quantized_dtype)._as_c()
        infos = (_native.ReduceInfo * n)()
        code = self._lib.pccltAllReduceMultipleWithRetry(
            self._h, ptrs, ptrs, counts, int(dt), descs, n, infos)
        _check(code, "all_reduce_multiple_with_retry")
        return [ReduceInfo(i.tx_bytes, i.rx_bytes, i.world_size) for i in infos]

    # -- shared state --

    def sync_shared_state(self, state: SharedState,
                          strategy: SharedStateSyncStrategy =
                          SharedStateSyncStrategy.ENFORCE_POPULAR,
                          ) -> SharedStateSyncInfo:
        keepalive: list = []
        infos = (_native.TensorInfoC * len(state.infos))()
        for i, ti in enumerate(state.infos):
            infos[i] = ti._as_c(keepalive)
        st = _native.SharedStateC(revision=state.revision, count=len(state.infos),
                                  infos=infos)
        out = _native.SharedStateSyncInfo()
        code = self._lib.pccltSynchronizeSharedState(
            self._h, ctypes.byref(st), int(strategy), ctypes.byref(out))
        _check(code, "sync_shared_state")
        for i, ti in enumerate(state.infos):
            ti.updated = bool(infos[i].updated)
        return SharedStateSyncInfo(out.tx_bytes, out.rx_bytes, out.revision)
