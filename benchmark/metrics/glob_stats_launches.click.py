"""Host calls that put work on a stream (kernel and graph launches,
asynchronous copies, by the CUDA runtime's names) whose start falls inside a
``glob.stats`` span, per traced action: the stats chain's eager launches.
A program without ``glob.stats`` spans reads nothing."""

import bisect

from harness.readers import per_unit
from harness.spans import intervals
from harness.trace import LAUNCH_CALLS


def read(ctx):
    tr = ctx["trace"]
    iv = intervals(tr, "glob.stats")
    if not iv:
        return None
    starts = [s for s, _e in iv]
    n = 0
    for e in tr.host:
        if e["name"] in LAUNCH_CALLS:
            k = bisect.bisect_right(starts, e["ts"]) - 1
            n += k >= 0 and e["ts"] <= iv[k][1]
    return per_unit(ctx, n, "actions")
