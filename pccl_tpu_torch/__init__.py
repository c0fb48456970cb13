"""pccl_tpu_torch — the PyTorch/CUDA port of pccl_tpu.

The same fault-tolerant collectives (the C++ core `libpcclt.so`, loaded with
ctypes) carry a PyTorch training loop on an NVIDIA Hopper card. The model
compute is plain PyTorch; the attention kernels are CUDA C++ written for
`sm_90a` (`pccl_tpu_torch/csrc`).

Importing this package loads nothing heavy: no torch, no native library, no
CUDA. Subpackages:

- `comm`: ctypes bindings of the native core (Communicator, MasterNode);
- `ops`: the flash-attention kernels, their plain versions and the build;
- `models`: the GPT family, with the JAX package's parameter layout;
- `parallel`: the train step, the flat-vector codec, the ring retry policy
  and sync DiLoCo;
- `examples`: `python -m pccl_tpu_torch.examples.sync_diloco`.
"""

__version__ = "0.1.0"
