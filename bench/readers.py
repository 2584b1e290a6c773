"""Helpers the metric readers (bench/metrics/*.py) share: span seconds
per call of the window, a count per call, the idle share and the
kernels' roofline share."""
import re


def span_ms_per_call(ctx, names):
    """Milliseconds of the named spans (summed) per call of the window,
    or None when none of them was recorded."""
    spans = ctx["spans"]
    hits = [spans[n]["sum_s"] for n in names if n in spans]
    if not hits or not ctx["calls"]:
        return None
    return 1e3 * sum(hits) / len(ctx["calls"])


def per_call(ctx, value):
    """``value`` per call of the window, or None without calls."""
    if value is None or not ctx["calls"]:
        return None
    return value / len(ctx["calls"])


def idle_pct(ctx):
    """100 x (1 - busy / window) of the traced window, or None when the
    profiler saw no device work."""
    p = ctx["profile"]
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_ops(ctx, kernel: str):
    """(device seconds, launches) of one CUDA function in the profile."""
    pat = re.compile(r"\b" + re.escape(kernel) + r"\b")
    hits = [v for n, v in ctx["profile"]["ops"].items() if pat.search(n)]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def roofline_pct(ctx, kernels):
    """Percent of the card's roofline the named kernels reach together:
    the sum over their launches of the least time the card could take
    (each kernel's ``launches`` in bench/roofline), over the sum of their
    profiled device times.  None when a kernel that ran has launches of
    unknown shapes (a tiled cell's unit chunks) or no kernel ran."""
    from bench import roofline

    if not ctx["profile"]:
        return None
    mods = roofline.kernels()
    bound = device = 0.0
    for kernel in kernels:
        secs, n = kernel_ops(ctx, kernel)
        if n == 0:
            continue
        launches = mods[kernel].launches(ctx["config"], n, len(ctx["calls"]))
        if launches is None:
            return None
        bound += sum(roofline.bound_s(*t) * k for t, k in launches)
        device += secs
    if device <= 0:
        return None
    return 100.0 * bound / device
