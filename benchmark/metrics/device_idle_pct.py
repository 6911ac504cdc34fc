"""device_idle_pct.<pair|batch>: the share of the traced window in which
no kernel, copy or fill ran on the card (torch.profiler over a few calls
of the entry, each ending in its copy off the card)."""


def read(ctx):
    w0, w1 = ctx["trace"]["window_us"]
    if w1 <= w0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_us"] / (w1 - w0))
