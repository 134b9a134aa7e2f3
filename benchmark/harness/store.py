"""Host slots for the answers that the check samples during the window,
allocated and written once in set-up.

Keeping a sampled answer in the window allocates nothing: its arrays are
copied into the next free slot (a device tensor by one copy to the host),
and the program's own arrays are let go as they would be without the
check. Answers kept by reference, or read into a fresh host array each,
make the program's next calls take fresh pages, and each sampled action
was then followed by a slower one. A full store samples no more: the
sample is the seeded picks of the window, up to the store's capacity."""

from __future__ import annotations

import numpy as np


def _np_dtype(a) -> np.dtype:
    if isinstance(a, np.ndarray):
        return a.dtype
    import torch
    return torch.empty(0, dtype=a.dtype).numpy().dtype


class Store:
    def __init__(self, capacity: int, like: dict):
        """``like``: an answer of the kind to be kept, {name: array or
        tensor}, which gives each slot's shape and type."""
        self.capacity = int(capacity)
        self.slots = {}
        for name, a in like.items():
            # np.ones writes every page now, not at the first sample
            self.slots[name] = np.ones((self.capacity, *a.shape),
                                       _np_dtype(a))
        self.meta: list = []

    def __len__(self) -> int:
        return len(self.meta)

    def full(self) -> bool:
        return len(self.meta) >= self.capacity

    def put(self, meta, **answer) -> int:
        """Copies ``answer`` into the next slot; returns its index."""
        j = len(self.meta)
        for name, a in answer.items():
            dst = self.slots[name][j]
            if isinstance(a, np.ndarray):
                np.copyto(dst, a)
            else:
                import torch
                torch.from_numpy(dst).copy_(a)
        self.meta.append(meta)
        return j

    def get(self, name: str, j: int) -> np.ndarray:
        return self.slots[name][j]
