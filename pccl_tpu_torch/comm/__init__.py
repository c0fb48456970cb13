"""pccl_tpu_torch.comm — fault-tolerant collectives over TCP (native core).

The native library loads lazily on first Communicator/MasterNode use, so
importing this package never needs the C++ build.
"""

from .api import (  # noqa: F401
    AsyncReduceHandle,
    Attribute,
    Communicator,
    ConnectionLostError,
    DataType,
    DeviceType,
    KickedError,
    MasterNode,
    MasterUnreachableError,
    OperationAbortedError,
    PcclError,
    QuantizationAlgorithm,
    ReduceDescriptor,
    ReduceInfo,
    ReduceOp,
    Result,
    SharedState,
    SharedStateSyncInfo,
    SharedStateSyncStrategy,
    TensorInfo,
    TooFewPeersError,
    build_info,
    netem_inject,
    shm_ndarray,
    trace_clear,
    trace_dump,
    trace_enable,
    trace_events,
)
