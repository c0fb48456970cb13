"""The card's idle share over the traced window: 1 - the union of every
kernel, copy and set of the card's peers (torch.profiler in each peer,
put on the host's one wall clock) over the window, in %; averaged over
the cards."""


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
