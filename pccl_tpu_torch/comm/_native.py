"""ctypes loader for the native core (libpcclt.so).

Declares the structs and signatures of the pcclt C API
(`pccl_tpu/native/include/pcclt.h`) that this package calls. The library is
the repository's C++ core; the port shares the binary, not Python code.

Search order: `PCCLT_LIB`, then this package's own `build/libpcclt.so`, then
`pccl_tpu/native/build/libpcclt.so` of the source tree. When none exists,
`load()` builds the library into `pccl_tpu_torch/build/` (ops/_build.py).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

_LIB = None

PKG_DIR = Path(__file__).resolve().parent.parent
REPO_DIR = PKG_DIR.parent


def candidate_paths():
    env = os.environ.get("PCCLT_LIB")
    if env:
        yield Path(env)
    yield PKG_DIR / "build" / "libpcclt.so"
    yield REPO_DIR / "pccl_tpu" / "native" / "build" / "libpcclt.so"


def find_library():
    """Path of the first existing candidate, or None."""
    for p in candidate_paths():
        if p.exists():
            return p
    return None


def load():
    """Load libpcclt.so (building it when none is found) and declare
    signatures."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = find_library()
    if path is None:
        from ..ops import _build

        path = _build.build_pcclt()
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    _LIB = lib
    return lib


class CommCreateParams(ctypes.Structure):
    _fields_ = [
        ("master_ip", ctypes.c_char_p),
        ("master_port", ctypes.c_uint16),
        ("peer_group", ctypes.c_uint32),
        ("advertised_ip", ctypes.c_char_p),
        ("p2p_port", ctypes.c_uint16),
        ("ss_port", ctypes.c_uint16),
        ("bench_port", ctypes.c_uint16),
        ("p2p_connection_pool_size", ctypes.c_uint32),
        # master HA reconnect: -1 = env default, 0 = disabled; ms, 0 = env
        ("reconnect_attempts", ctypes.c_int32),
        ("reconnect_backoff_ms", ctypes.c_uint32),
        ("reconnect_backoff_cap_ms", ctypes.c_uint32),
    ]


class ReduceDescriptor(ctypes.Structure):
    _fields_ = [
        ("tag", ctypes.c_uint64),
        ("op", ctypes.c_int),
        ("quant_algo", ctypes.c_int),
        ("quant_dtype", ctypes.c_int),
    ]


class ReduceInfo(ctypes.Structure):
    _fields_ = [
        ("tx_bytes", ctypes.c_uint64),
        ("rx_bytes", ctypes.c_uint64),
        ("world_size", ctypes.c_uint32),
    ]


MaterializeFn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class TensorInfoC(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("data", ctypes.c_void_p),
        ("count", ctypes.c_uint64),
        ("dtype", ctypes.c_int),
        ("device", ctypes.c_int),
        ("allow_content_inequality", ctypes.c_int),
        # accelerator-resident entries; host entries leave them zero
        ("precomputed_hash", ctypes.c_uint64),
        ("has_precomputed_hash", ctypes.c_int),
        ("materialize", MaterializeFn),
        ("materialize_ctx", ctypes.c_void_p),
        ("updated", ctypes.c_int),
    ]


class SharedStateC(ctypes.Structure):
    _fields_ = [
        ("revision", ctypes.c_uint64),
        ("count", ctypes.c_uint64),
        ("infos", ctypes.POINTER(TensorInfoC)),
    ]


class SharedStateSyncInfo(ctypes.Structure):
    _fields_ = [
        ("tx_bytes", ctypes.c_uint64),
        ("rx_bytes", ctypes.c_uint64),
        ("revision", ctypes.c_uint64),
    ]


class CommStats(ctypes.Structure):
    """Counters of one communicator (Communicator.stats()["counters"]),
    monotonic since connect; the trace-ring fields are process-global."""
    _fields_ = [
        ("collectives_ok", ctypes.c_uint64),
        ("collectives_aborted", ctypes.c_uint64),
        ("collectives_connection_lost", ctypes.c_uint64),
        ("topology_updates", ctypes.c_uint64),
        ("topology_optimizes", ctypes.c_uint64),
        ("syncs_ok", ctypes.c_uint64),
        ("syncs_failed", ctypes.c_uint64),
        ("sync_hash_mismatches", ctypes.c_uint64),
        ("kicked", ctypes.c_uint64),
        ("peers_joined", ctypes.c_uint64),
        ("peers_left", ctypes.c_uint64),
        ("master_reconnects", ctypes.c_uint64),
        ("p2p_conns_reused", ctypes.c_uint64),
        ("telemetry_digests", ctypes.c_uint64),
        ("trace_ring_dropped", ctypes.c_uint64),
        ("relay_forwarded", ctypes.c_uint64),
        ("chaos_faults_armed", ctypes.c_uint64),
        ("chaos_faults_activated", ctypes.c_uint64),
        ("trace_ring_pushed", ctypes.c_uint64),
        ("trace_ring_capacity", ctypes.c_uint64),
        ("ss_chunks_fetched", ctypes.c_uint64),
        ("ss_chunks_resourced", ctypes.c_uint64),
        ("ss_chunks_dup", ctypes.c_uint64),
        ("ss_chunk_bytes_fetched", ctypes.c_uint64),
        ("ss_chunk_bytes_resourced", ctypes.c_uint64),
        ("ss_chunk_bytes_dup", ctypes.c_uint64),
        ("ss_seeder_chunks_served", ctypes.c_uint64),
        ("ss_seeder_promotions", ctypes.c_uint64),
        ("ss_seeders_lost", ctypes.c_uint64),
        ("ss_legacy_syncs", ctypes.c_uint64),
        ("relay_acks", ctypes.c_uint64),
        ("relay_retired_early", ctypes.c_uint64),
        ("sched_ops_ring", ctypes.c_uint64),
        ("sched_ops_tree", ctypes.c_uint64),
        ("sched_ops_butterfly", ctypes.c_uint64),
        ("sched_ops_mesh", ctypes.c_uint64),
        ("sched_ops_relay", ctypes.c_uint64),
        ("sched_steps", ctypes.c_uint64),
        ("sched_relay_planned_bytes", ctypes.c_uint64),
        ("ss_chunks_delta_skipped", ctypes.c_uint64),
        ("ss_chunk_bytes_delta_skipped", ctypes.c_uint64),
    ]


class EdgeStats(ctypes.Structure):
    """Counters of one edge, keyed by the remote peer's advertised p2p
    endpoint (Communicator.stats()["edges"])."""
    _fields_ = [
        ("endpoint", ctypes.c_char * 64),
        ("tx_bytes", ctypes.c_uint64),
        ("rx_bytes", ctypes.c_uint64),
        ("tx_frames", ctypes.c_uint64),
        ("rx_frames", ctypes.c_uint64),
        ("connects", ctypes.c_uint64),
        ("stall_ms", ctypes.c_uint64),
        ("tx_zc_frames", ctypes.c_uint64),
        ("tx_zc_reaps", ctypes.c_uint64),
        ("wd_state", ctypes.c_uint64),
        ("wd_suspects", ctypes.c_uint64),
        ("wd_confirms", ctypes.c_uint64),
        ("wd_reissues", ctypes.c_uint64),
        ("wd_relays", ctypes.c_uint64),
        ("rx_relay_bytes", ctypes.c_uint64),
        ("rx_relay_windows", ctypes.c_uint64),
        ("dup_bytes", ctypes.c_uint64),
        ("dup_windows", ctypes.c_uint64),
        ("tx_sync_bytes", ctypes.c_uint64),
        ("rx_sync_bytes", ctypes.c_uint64),
        ("tx_stripe_windows", ctypes.c_uint64),
        ("tx_stripe_bytes", ctypes.c_uint64),
    ]


def _declare(lib):
    c = ctypes
    P = c.POINTER

    lib.pccltCreateMaster.restype = c.c_int
    lib.pccltCreateMaster.argtypes = [c.c_char_p, c.c_uint16, P(c.c_void_p)]
    lib.pccltCreateMasterEx.restype = c.c_int
    lib.pccltCreateMasterEx.argtypes = [c.c_char_p, c.c_uint16, c.c_char_p,
                                        P(c.c_void_p)]
    for fn in ("pccltRunMaster", "pccltInterruptMaster",
               "pccltMasterAwaitTermination", "pccltDestroyMaster"):
        f = getattr(lib, fn)
        f.restype = c.c_int
        f.argtypes = [c.c_void_p]
    lib.pccltMasterPort.restype = c.c_uint16
    lib.pccltMasterPort.argtypes = [c.c_void_p]
    lib.pccltMasterEpoch.restype = c.c_uint64
    lib.pccltMasterEpoch.argtypes = [c.c_void_p]
    lib.pccltMasterMetricsPort.restype = c.c_uint16
    lib.pccltMasterMetricsPort.argtypes = [c.c_void_p]
    lib.pccltMasterGetHealth.restype = c.c_int
    lib.pccltMasterGetHealth.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64,
                                         P(c.c_uint64)]
    lib.pccltInit.restype = c.c_int
    lib.pccltInit.argtypes = []
    lib.pccltGetBuildInfo.restype = c.c_char_p
    lib.pccltGetBuildInfo.argtypes = []

    # fleet-scale load and timing hooks: a flood of observer sessions
    # pushing telemetry digests, the dispatcher's admission latency, and a
    # journal's write and cold-restart replay
    lib.pccltDigestFlood.restype = c.c_int
    lib.pccltDigestFlood.argtypes = [c.c_char_p, c.c_uint16, c.c_uint32,
                                     c.c_uint32, c.c_double, c.c_double,
                                     c.c_uint32, P(c.c_uint64), P(c.c_double)]
    lib.pccltAdmissionProbe.restype = c.c_int
    lib.pccltAdmissionProbe.argtypes = [c.c_char_p, c.c_uint16, c.c_uint32,
                                        P(c.c_double), P(c.c_double)]
    lib.pccltMasterReplayBench.restype = c.c_int
    lib.pccltMasterReplayBench.argtypes = [c.c_char_p, c.c_uint32,
                                           P(c.c_double), P(c.c_double)]

    lib.pccltCreateCommunicator.restype = c.c_int
    lib.pccltCreateCommunicator.argtypes = [P(CommCreateParams), P(c.c_void_p)]
    for fn in ("pccltDestroyCommunicator", "pccltConnect", "pccltUpdateTopology",
               "pccltOptimizeTopology"):
        f = getattr(lib, fn)
        f.restype = c.c_int
        f.argtypes = [c.c_void_p]
    lib.pccltGetAttribute.restype = c.c_int
    lib.pccltGetAttribute.argtypes = [c.c_void_p, c.c_int, P(c.c_int64)]
    lib.pccltArePeersPending.restype = c.c_int
    lib.pccltArePeersPending.argtypes = [c.c_void_p, P(c.c_int)]

    lib.pccltAllReduce.restype = c.c_int
    lib.pccltAllReduce.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_uint64,
                                   c.c_int, P(ReduceDescriptor), P(ReduceInfo)]
    lib.pccltAllReduceAsync.restype = c.c_int
    lib.pccltAllReduceAsync.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                        c.c_uint64, c.c_int, P(ReduceDescriptor)]
    lib.pccltAwaitAsyncReduce.restype = c.c_int
    lib.pccltAwaitAsyncReduce.argtypes = [c.c_void_p, c.c_uint64, P(ReduceInfo)]
    lib.pccltAllReduceMultipleWithRetry.restype = c.c_int
    lib.pccltAllReduceMultipleWithRetry.argtypes = [
        c.c_void_p, P(c.c_void_p), P(c.c_void_p), P(c.c_uint64), c.c_int,
        P(ReduceDescriptor), c.c_uint64, P(ReduceInfo)]

    lib.pccltAllGather.restype = c.c_int
    lib.pccltAllGather.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                   c.c_uint64, c.c_uint64, c.c_int,
                                   c.c_uint64, P(ReduceInfo)]
    lib.pccltGatherSlot.restype = c.c_int
    lib.pccltGatherSlot.argtypes = [c.c_void_p, P(c.c_uint64)]
    lib.pccltReduceScatter.restype = c.c_int
    lib.pccltReduceScatter.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_uint64, c.c_uint64,
        c.c_int, P(ReduceDescriptor), P(c.c_uint64), P(c.c_uint64),
        P(ReduceInfo)]
    lib.pccltBroadcast.restype = c.c_int
    lib.pccltBroadcast.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64,
                                   c.c_uint64, c.c_int, P(ReduceDescriptor),
                                   P(ReduceInfo)]
    lib.pccltAllToAll.restype = c.c_int
    lib.pccltAllToAll.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                  c.c_uint64, c.c_uint64, c.c_int,
                                  P(ReduceDescriptor), P(ReduceInfo)]

    # telemetry: counters (always on), the process-global event recorder,
    # and scripted faults on the wire-emulation edges
    lib.pccltCommGetStats.restype = c.c_int
    lib.pccltCommGetStats.argtypes = [c.c_void_p, P(CommStats)]
    lib.pccltCommGetEdgeStats.restype = c.c_int
    lib.pccltCommGetEdgeStats.argtypes = [c.c_void_p, P(EdgeStats), c.c_uint64,
                                          P(c.c_uint64)]
    lib.pccltTraceEnable.restype = c.c_int
    lib.pccltTraceEnable.argtypes = [c.c_int]
    lib.pccltTraceClear.restype = c.c_int
    lib.pccltTraceClear.argtypes = []
    lib.pccltTraceDump.restype = c.c_int
    lib.pccltTraceDump.argtypes = [c.c_char_p]
    lib.pccltNetemInject.restype = c.c_int
    lib.pccltNetemInject.argtypes = [c.c_char_p, c.c_char_p]
    # what a connection to ip:port would emulate under the PCCLT_WIRE_* env
    lib.pccltWireModelQuery.restype = c.c_int
    lib.pccltWireModelQuery.argtypes = [c.c_char_p, c.c_uint16, P(c.c_double),
                                        P(c.c_double), P(c.c_double),
                                        P(c.c_double)]

    lib.pccltHashBuffer.restype = c.c_uint64
    lib.pccltHashBuffer.argtypes = [c.c_int, c.c_void_p, c.c_uint64]

    # registered shared-memory regions (api.shm_ndarray)
    lib.pccltShmAlloc.restype = c.c_int
    lib.pccltShmAlloc.argtypes = [c.c_uint64, P(c.c_void_p)]
    lib.pccltShmFree.restype = c.c_int
    lib.pccltShmFree.argtypes = [c.c_void_p]

    lib.pccltSynchronizeSharedState.restype = c.c_int
    lib.pccltSynchronizeSharedState.argtypes = [c.c_void_p, P(SharedStateC), c.c_int,
                                                P(SharedStateSyncInfo)]
