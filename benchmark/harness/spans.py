"""The program's own spans in a trace (``ideepcolor_tpu_torch``'s
``utils.profiling.annotate``: ``click``, ``click.hints``, ``batch.upload``,
``graph.copy``, ...), read against the device's busy intervals.

"Idle under a span" is the length of the union of the span's intervals in
the window, less the part of it that the device's union covers: time in
which the program was inside the span and the card ran nothing. Each
reader returns None where the trace holds no span of the name it needs
(the span's code was bypassed, or the program opens no spans), never a
false 0."""

from __future__ import annotations

from .trace import union


def intervals(tr, name: str) -> list[tuple[float, float]]:
    """The merged intervals of the program's spans named ``name``, clipped
    to the window; nested and repeated spans count once."""
    return union((max(e["ts"], tr.t0), min(e["ts"] + e.get("dur", 0.0),
                                           tr.t1))
                 for e in tr.host if e["cat"] == "user_annotation"
                 and e["name"] == name)


def count(tr, name: str) -> int:
    """How many spans named ``name`` the window holds."""
    return sum(1 for e in tr.host if e["cat"] == "user_annotation"
               and e["name"] == name)


def covered(a, b) -> float:
    """Length of the overlap of two merged, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(tr, name: str) -> float | None:
    """Seconds inside spans ``name`` with the device idle; None without
    such a span."""
    iv = intervals(tr, name)
    if not iv:
        return None
    return (sum(e - s for s, e in iv) - covered(iv, tr.busy)) * 1e-6


def idle_ms_per_action(ctx, name: str) -> float | None:
    """Idle under spans ``name``, in ms per traced action (a batch is one
    action)."""
    idle = idle_under(ctx["trace"], name)
    if idle is None or not ctx["work"]:
        return None
    return 1e3 * idle / len(ctx["work"])


def count_under(ctx, name: str, root: str) -> int | None:
    """Spans ``name`` in the window, which may be 0; None where the program
    opened no ``root`` span, so a program without spans reads nothing."""
    tr = ctx["trace"]
    return count(tr, name) if count(tr, root) else None
