"""Arithmetic the per-layer metric files share: shares of the window,
of a FLOP/s peak and of a kernel's roofline. Each returns None where the
trace holds nothing for it to read."""

from __future__ import annotations

from . import peaks


def idle_pct(ctx) -> float:
    return 100.0 * ctx["trace"].idle_share()


def mfu_pct(ctx) -> float | None:
    """FLOPs of the traced actions (counted from the configuration's layer
    shapes) over the traced window, as a share of the peak of the path's
    compute type."""
    flops = sum(w["flops"] for w in ctx["work"])
    prec = ctx["config"]["precision"][ctx["mix"]["entry"]]
    if not flops:
        return None
    return 100.0 * flops / ctx["trace"].window_s / peaks.FLOPS[prec]


def per_unit(ctx, value: float, unit: str) -> float | None:
    n = sum(w[unit] for w in ctx["work"]) if unit != "actions" else len(
        ctx["work"])
    return value / n if n else None


def roofline_pct(ctx, kernel_names, nbytes: float, ops: float = 0.0,
                 ops_peak: float = peaks.FLOPS["float32"]) -> float | None:
    """Least time of the work (the larger of its bytes over the HBM rate
    and its operations over ``ops_peak``) over the device time of the
    kernels named, as a share."""
    t = ctx["trace"].kernel_s(*kernel_names)
    if t <= 0 or nbytes <= 0:
        return None
    least = max(nbytes / peaks.HBM_BYTES_PER_S, ops / ops_peak)
    return 100.0 * least / t
