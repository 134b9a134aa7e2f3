"""The sample store: slots allocated and written in set-up, answers
copied in (numpy arrays and tensors alike), and no sample past its
capacity."""

import numpy as np
import pytest
import torch

from harness.store import Store


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_answers_are_copied_into_their_slots(kind):
    like = {"frame": np.zeros((4, 4, 3), np.uint8),
            "ab": torch.zeros((4, 4, 2))}
    st = Store(2, like)
    assert st.slots["frame"].dtype == np.uint8
    assert st.slots["ab"].dtype == np.float32
    ab = torch.full((4, 4, 2), 1.5)
    frame = np.full((4, 4, 3), 7, np.uint8)
    if kind == "tensor":
        frame = torch.from_numpy(frame)
    j = st.put("first", frame=frame, ab=ab)
    ab.fill_(0.0)                      # the program writes its buffer again
    assert j == 0 and len(st) == 1 and not st.full()
    assert np.all(st.get("frame", 0) == 7) and np.all(st.get("ab", 0) == 1.5)
    st.put("second", frame=frame, ab=ab)
    assert st.full() and st.meta == ["first", "second"]


def test_an_empty_store_is_full():
    assert Store(0, {"map": np.zeros(3, np.float32)}).full()
