"""The comparisons that decide ``correct``: each number is the worst over
the sampled answers, and each has a limit of its own in the cell's
workload file."""

from __future__ import annotations

import math

import numpy as np


def frame_diff_share(port, ref) -> float:
    """Largest share, over frames, of the uint8 values that differ."""
    return max(float(np.mean(p != r)) for p, r in zip(port, ref))


def frame_lsb_max(port, ref) -> float:
    """Largest difference of a uint8 value, in steps."""
    return max(float(np.max(np.abs(p.astype(np.int16) - r.astype(np.int16))))
               for p, r in zip(port, ref))


def ab_err_mean(port, ref) -> float:
    """Largest mean absolute difference, over frames, of ``output_ab``."""
    return max(float(np.mean(np.abs(p - r))) for p, r in zip(port, ref))


def map_err_max(port, ref) -> float:
    """Largest absolute difference of a distribution's probability."""
    return max(float(np.max(np.abs(p - r))) for p, r in zip(port, ref))


NUMBERS = {"frame_diff_share": ("frame", frame_diff_share),
           "frame_lsb_max": ("frame", frame_lsb_max),
           "ab_err_mean": ("ab", ab_err_mean),
           "map_err_max": ("map", map_err_max)}


def compare(port: dict, ref: dict, names) -> dict:
    """{number: value} for the numbers ``names`` over the outputs both
    sides hold (lists of arrays by output name): None where neither side
    holds that output, NaN where only one does or their counts differ."""
    out = {}
    for name in names:
        key, fn = NUMBERS[name]
        p, r = port.get(key, []), ref.get(key, [])
        if not p and not r:
            out[name] = None
        else:
            out[name] = fn(p, r) if p and len(p) == len(r) else math.nan
    return out


class Tally:
    """Running worst of each number over blocks of compared answers."""

    def __init__(self, names):
        self.names = list(names)
        self.worst = {n: -math.inf for n in self.names}
        self.compared = 0

    def add(self, port: dict, ref: dict, n: int) -> None:
        for k, v in compare(port, ref, self.names).items():
            if v is not None:
                self.worst[k] = (math.nan if math.isnan(v) or math.isnan(
                    self.worst[k]) else max(self.worst[k], v))
        self.compared += n

    def result(self, limits: dict) -> tuple[bool, dict]:
        nums = {n: {"value": (None if not math.isfinite(self.worst[n])
                              else self.worst[n]), "limit": limits[n]}
                for n in self.names}
        ok = self.compared > 0 and all(
            v["value"] is not None and v["value"] <= v["limit"]
            for v in nums.values())
        return ok, nums
