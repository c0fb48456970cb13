"""Seconds of an outer step's ring: the `ring_reduce` phase of
Diloco.last_profile (the AVG of the outer vector over comm/ and
libpcclt.so, staged through pinned host buffers; DilocoConfig(profile=True),
on in the traced run), the mean over every peer's outer steps in the traced
window. None where no outer step ran a ring (a peer alone on its card)."""


def read(ctx):
    steps = [o["profile"]["ring_reduce"] for r in ctx["records"] for o in r.get("outer", [])
             if o.get("profile") and "ring_reduce" in o["profile"]]
    if not steps or not any(steps):
        return None
    return sum(steps) / len(steps)
