"""The ``suggest`` spans of a trace's probe actions (``get_ab_reccs`` on a
map predicted before: no ``click`` span, the forward's, lies between such a
span and the ``suggest`` span before it), read against the device: the
readers of the suggestion chain's metrics. A trace without ``suggest``
spans reads nothing."""

from __future__ import annotations

from .spans import covered


def probe_intervals(tr) -> list[tuple[float, float]]:
    """The (start, end) of each probe action's ``suggest`` span, clipped to
    the window, in time order."""
    marks = sorted((e["ts"], e["name"], e.get("dur", 0.0)) for e in tr.host
                   if e["cat"] == "user_annotation"
                   and e["name"] in ("click", "suggest"))
    out, clicked = [], False
    for ts, name, dur in marks:
        if name == "click":
            clicked = True
            continue
        if not clicked:
            out.append((max(ts, tr.t0), min(ts + dur, tr.t1)))
        clicked = False
    return out


def busy_ms(tr, iv) -> float:
    """Device-busy milliseconds inside the intervals ``iv``."""
    return 1e3 * covered(iv, tr.busy) * 1e-6


def per_span(tr, value_of) -> float | None:
    """``value_of(tr, intervals)`` over the probe spans, per span; None
    without one."""
    iv = probe_intervals(tr)
    return value_of(tr, iv) / len(iv) if iv else None
