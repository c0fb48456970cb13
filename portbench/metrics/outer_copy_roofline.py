"""The outer step's copies against their least time, in %: over the traced
window's outer steps (every peer's), the least time of the phases
delta_compute, d2h, h2d_apply and unflat_out over their seconds in
Diloco.last_profile (DilocoConfig(profile=True), on in the traced run).

With N the outer vector's elements (fp32), each operand read once and
written once:

    delta_compute  outer - inner -> delta          12N over HBM
    d2h            delta -> pinned host             4N over the host link
    h2d_apply      host -> delta, then Nesterov's   4N over the link
                   three in-place adds (each reads     + 36N over HBM
                   two vectors and writes one)
    unflat_out     outer -> the parameters          8N over HBM

HBM is flops.peaks; the link is PCIe Gen5 x16, 64 GB/s a direction (the
H100 SXM data sheet's 128 GB/s both ways), keyed by the card's name. N is
counted from the port's parameter shapes at the cell's configuration.

In one cell the least time is fixed, so the share moves only with those
phases' seconds (outer_copy_s less stage_copy); what it adds is their
distance from the hardware's least time, comparable across cells.
"""

import math

# bytes an element of the outer vector moves: (over HBM, over the host link)
PHASE_BYTES = {"delta_compute": (12, 0), "d2h": (0, 4), "h2d_apply": (36, 4),
               "unflat_out": (8, 0)}

LINK = {"NVIDIA H100 80GB HBM3": 64e9}


def link(device_name: str) -> float:
    """Bytes/s of one direction of the card's host link; KeyError for a
    card not listed, as flops.peaks."""
    return LINK[device_name]


def outer_count(config: dict, block: int) -> int:
    """Elements of the outer vector: the port's parameters at the
    configuration."""
    from pccl_tpu_torch.parallel.train import family

    from portbench import port

    cfg = port.model_config(config, block)
    return sum(math.prod(s) for s in family(cfg).param_shapes(cfg).values())


def read(ctx):
    profiles = [o["profile"] for r in ctx["records"] for o in r.get("outer", [])
                if o.get("profile")]
    if not profiles:
        return None
    cell = ctx["cell"]
    n = outer_count(cell.config, cell.traffic["block"])
    _, hbm = ctx["flops"].peaks(ctx["device_name"])
    host_link = link(ctx["device_name"])
    least = spent = 0.0
    for p in profiles:
        for phase, (hbm_b, link_b) in PHASE_BYTES.items():
            if phase in p:
                least += n * (hbm_b / hbm + link_b / host_link)
                spent += p[phase]
    if spent <= 0:
        return None
    return 100.0 * least / spent
