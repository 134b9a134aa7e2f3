"""put_points_json and points_json_to_table of the port against the JAX
functions: valid, edge and malformed hint lists give the same arrays, or
the same exception type."""

import numpy as np
import pytest

from ideepcolor_tpu.ops import hints as jhints
from ideepcolor_tpu_torch.ops import hints as thints

S = 64
CASES = {
    "none": None,
    "empty": [],
    "one": [{"y": 30, "x": 30, "ab": [40.0, -50.0], "radius": 2}],
    "default_radius": [{"y": 10, "x": 50, "ab": [1, 2]}],
    "overlap_later_wins": [{"y": 20, "x": 20, "ab": [10.0, 10.0],
                            "radius": 5},
                           {"y": 22, "x": 23, "ab": [-30.0, 7.5],
                            "radius": 3}],
    "edges_clamped": [{"y": 0, "x": 0, "ab": [50.0, 40.0], "radius": 3},
                      {"y": -9, "x": 99, "ab": [-5.0, 5.0], "radius": 1},
                      {"y": S - 1, "x": S, "ab": [3.0, 4.0], "radius": 0}],
    "string_numbers": [{"y": "12", "x": 7.9, "ab": ["3.5", 2],
                        "radius": "1"}],
    "max_radius": [{"y": 31, "x": 31, "ab": [1.0, 1.0], "radius": S // 2 - 1}],
    "full_table": [{"y": i % S, "x": (5 * i) % S, "ab": [i % 90, -i % 70],
                    "radius": i % 4} for i in range(256)],
    "past_table": [{"y": 1, "x": 1, "ab": [0, 0], "radius": 0}] * 257,
    "radius_too_big": [{"y": 0, "x": 0, "ab": [1, 2], "radius": S // 2}],
    "radius_negative": [{"y": 5, "x": 5, "ab": [1, 2], "radius": -1}],
    "not_a_list": {"y": 0},
    "missing_ab": [{"y": 0, "x": 0}],
    "missing_y": [{"x": 0, "ab": [1, 2]}],
    "short_ab": [{"y": 3, "x": 3, "ab": [1]}],
    "bad_number": [{"y": "top", "x": 3, "ab": [1, 2]}],
    "not_a_dict": [[1, 2, 3]],
    "null_ab": [{"y": 3, "x": 3, "ab": None}],
}


def _run(mod, fn, hints):
    """(result arrays, or the exception type) of one function."""
    try:
        if fn == "dense":
            ab = np.zeros((2, S, S), np.float32)
            mask = np.zeros((1, S, S), np.float32)
            out = mod.put_points_json(ab, mask, hints, S)
            assert out[0] is ab and out[1] is mask      # in place
            return ab, mask
        return mod.points_json_to_table(hints, S)
    except Exception as e:           # noqa: BLE001 - compared by type
        return type(e)


@pytest.mark.parametrize("fn", ["dense", "table"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_hint_lists_match_jax(case, fn):
    hints = CASES[case]
    want, got = _run(jhints, fn, hints), _run(thints, fn, hints)
    if isinstance(want, type):
        assert got is want, (got, want)
        return
    if want is None:                 # the table overflowed: dense fallback
        assert got is None
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("case", ["one", "overlap_later_wins",
                                  "edges_clamped", "full_table"])
def test_table_rasterizes_to_the_dense_planes(case):
    """K1's plain version on the table gives put_points_json's planes."""
    import torch
    hints = CASES[case]
    ab = np.zeros((2, S, S), np.float32)
    mask = np.zeros((1, S, S), np.float32)
    thints.put_points_json(ab, mask, hints, S)
    boxes, values, count = thints.points_json_to_table(hints, S)
    r_ab, r_mask = thints.rasterize_hints(torch.from_numpy(boxes),
                                          torch.from_numpy(values), count, S)
    assert np.array_equal(r_ab.numpy().transpose(2, 0, 1), ab)
    assert np.array_equal(r_mask.numpy().transpose(2, 0, 1), mask)
