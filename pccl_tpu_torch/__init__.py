"""pccl_tpu_torch — the PyTorch/CUDA port of pccl_tpu.

The same fault-tolerant collectives (the C++ core `libpcclt.so`, loaded with
ctypes) carry a PyTorch training loop on an NVIDIA Hopper card. The model
compute is plain PyTorch; the attention kernels are CUDA C++ written for
`sm_90a` (`pccl_tpu_torch/csrc`).

Importing this package loads nothing heavy: no torch, no native library, no
CUDA. Subpackages:

- `comm`: ctypes bindings of the native core (Communicator, MasterNode);
- `ops`: the flash-attention kernels, their plain versions and the build;
- `models`: the GPT and Llama families, with the JAX package's parameter
  layout and its checkpointing (remat) modes;
- `parallel`: the train step (with gradient accumulation), the flat-vector
  codec, the ring retry policy and sync and async DiLoCo;
- `utils`: the token pipeline, the section profiler, checkpoints and the
  leveled logger;
- `examples`: `python -m pccl_tpu_torch.examples.sync_diloco`, and the
  fault-tolerance soak, `python -m
  pccl_tpu_torch.examples.stress.stress_orchestrator`.
"""

__version__ = "0.1.0"

BUILD_INFO = {
    "name": "pccl_tpu_torch",
    "version": __version__,
    # the wire protocol of the native core, shared with the JAX package: rev
    # 2 carries family-tagged addresses
    "protocol": "PCCP/2",
}
