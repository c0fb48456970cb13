"""The experts' grouped products against their roofline, in %: over the
traced window's launches of the grouped GEMM (ops/moe_gemm.py), the sum of
each launch's least time over the sum of their device times by kernel name
from torch.profiler. A launch's least time is the larger of its FLOPs over
the bf16 peak and its bytes over HBM (flops.peaks), averaged over the
launch shapes of its variant in one pass of an expert layer (the model
type's family: moe_gemm_calls); dropless, so the work is the same whatever
the routing. None where the model type has no expert layer or the window
holds no such launch (a program without the kernel)."""

KERNELS = {"grouped_gemm<0, false, false": "moe_gemm_fwd",
           "grouped_gemm<0, false, true": "moe_gemm_dx",
           "grouped_gemm<1, true, false": "moe_gemm_dw"}


def least_s(calls: dict, peak_flops: float, peak_bytes: float) -> dict:
    """variant -> least seconds of one launch: the mean over its shapes."""
    return {v: sum(max(fl / peak_flops, nb / peak_bytes) for fl, nb in shapes) / len(shapes)
            for v, shapes in calls.items()}


def read(ctx):
    from portbench import spec

    calls, spent = {}, 0.0
    for r in ctx["records"]:
        for name, (n, ns) in r["trace"]["ops"].items():
            variant = next((v for tag, v in KERNELS.items() if tag in name), None)
            if variant is not None:
                calls[variant] = calls.get(variant, 0) + n
                spent += ns / 1e9
    cell = ctx["cell"]
    fam = spec.family(cell.config["model_type"])
    if spent <= 0 or not hasattr(fam, "moe_gemm_calls"):
        return None
    peak_flops, peak_bytes = ctx["flops"].peaks(ctx["device_name"])
    least_one = least_s(fam.moe_gemm_calls(cell.config, cell.traffic["batch"],
                                           cell.traffic["block"]), peak_flops, peak_bytes)
    return 100.0 * sum(n * least_one[v] for v, n in calls.items()) / spent
