"""Seconds of an outer step's phases other than the ring: the delta, D2H,
the stage copy, H2D with the Nesterov apply, and the unflatten into the
parameters (Diloco.last_profile, DilocoConfig(profile=True), on in the
traced run), the mean over every peer's outer steps in the traced window."""

COPY_PHASES = ("delta_compute", "d2h", "stage_copy", "h2d_apply", "unflat_out")


def read(ctx):
    steps = [o for r in ctx["records"] for o in r.get("outer", []) if o.get("profile")]
    if not steps:
        return None
    return sum(sum(o["profile"].get(k, 0.0) for k in COPY_PHASES)
               for o in steps) / len(steps)
