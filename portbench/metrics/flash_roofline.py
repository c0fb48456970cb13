"""K1-K3's share of their roofline: the sum over the traced window's calls
of each call's least time (flops.call_bounds over the model's attention
shapes, flops.flash_calls, weighted by their layers: FLOPs over the bf16
peak or bytes over HBM, the larger) over the sum of their device times by
kernel name from torch.profiler, in %."""

KERNELS = {"flash_fwd_kernel<": "flash_fwd", "flash_bwd_dq_kernel<": "flash_bwd_dq",
           "flash_bwd_dkv_kernel<": "flash_bwd_dkv"}


def read(ctx):
    f = ctx["flops"]
    cell = ctx["cell"]
    peak_flops, peak_bytes = f.peaks(ctx["device_name"])
    shapes = f.flash_calls(cell.config, cell.traffic["batch"], cell.traffic["block"])
    least_ms = f.call_bounds(shapes, peak_flops=peak_flops, peak_bytes=peak_bytes)
    least = spent = 0.0
    for r in ctx["records"]:
        for name, (calls, ns) in r["trace"]["ops"].items():
            kernel = next((k for tag, k in KERNELS.items() if tag in name), None)
            if kernel is None:
                continue
            least += calls * least_ms[kernel] / 1e3
            spent += ns / 1e9
    if spent <= 0:
        return None
    return 100.0 * least / spent
