"""The ring's rate, in Gbit/s: the bytes every peer's edges sent during the
traced window's outer steps (Communicator.stats()' tx_bytes, read around
each outer step) over the seconds of their `ring_reduce` phases
(Diloco.last_profile), summed over the peers: the mean rate a peer sends
at while its ring runs. None where no outer step ran a ring."""


def read(ctx):
    sent = seconds = 0.0
    for r in ctx["records"]:
        for o in r.get("outer", []):
            prof = o.get("profile") or {}
            if o.get("tx_bytes") and prof.get("ring_reduce"):
                sent += o["tx_bytes"]
                seconds += prof["ring_reduce"]
    if seconds <= 0:
        return None
    return sent * 8 / seconds / 1e9
