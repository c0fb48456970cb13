"""Which loaded modules a run may not hold: JAX's and the JAX package's,
compared by the whole top-level name (the part before the first dot), so
pccl_tpu_torch is not pccl_tpu."""

FORBIDDEN = ("jax", "jaxlib", "flax", "pccl_tpu")


def forbidden_modules(names) -> list:
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
