"""Pipelined interactive editing: asynchronous click dispatch and stale-frame
drop.

Counterpart of ``ideepcolor_tpu/engine/interactive.py``. The reference
recomputes synchronously on every mouse-motion event, so a drag's frame rate
is bounded by the whole dispatch + readback round trip. ``InteractiveSession``
splits the two sides:

  * ``submit(table)`` dispatches the table click program and returns at
    once. On the card that is one staged copy of the table, one graph
    replay, the copies of the outputs the session keeps, and one
    asynchronous copy of the display frame into pinned host memory with an
    event behind it; nothing waits for the device;
  * ``latest()`` materializes only the newest submitted frame (it waits on
    that frame's event) and drops the stale ones in flight unread;
  * the wrapped backend's state (``output_rgb``, ``output_ab``, the
    ``input_ab`` / ``input_mask`` mirrors) always reflects the newest
    *materialized* edit, so the getters and the save surface agree with what
    the user sees.

A captured program overwrites its outputs on the next replay, so everything
an in-flight frame carries is a copy of its own (``model._keep``,
``graphs.read_async``). The hint mirrors are rasterized on the host from the
submitted table by the native host runtime (``ops.host.rasterize_hints``).

Single consumer: call ``submit`` / ``latest`` from one thread.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..ops import host
from . import graphs


class InteractiveSession:
    """Asynchronous click pipeline over a backend's table click programs
    (``ColorizeImageTorch.prep_net`` builds ``_click_tbl`` and
    ``_click_tbl_win``).

    ``depth`` bounds the queue in flight: submitting past it drops the
    oldest frame not yet shown (its buffers are released, its pending copy
    is never waited for).
    """

    def __init__(self, model, depth: int = 4):
        if getattr(model, "_click_tbl", None) is None:
            raise ValueError(
                "backend has no table click program (prep_net a non-dist "
                "ColorizeImageTorch first)")
        self.model = model
        self.depth = max(1, depth)
        self._inflight: deque = deque()   # (seq, rgb, out_ab, finish, win?)
        self._seq = 0
        self._last_table = None
        self.frames_submitted = 0
        self.frames_materialized = 0
        self.frames_dropped = 0

    @property
    def pending(self) -> int:
        return len(self._inflight)

    def submit(self, boxes, values, count, win_args=None) -> int:
        """Dispatch one edit state; returns its sequence number.

        boxes (MAX_HINTS,4) int32, values (MAX_HINTS,2) f32, count live
        hints. With ``win_args = (l_win, rh, rw)`` the window-size display
        frame is composed in the same dispatch (the GUI path); otherwise the
        net-size frame is the display frame. Never blocks on the device.
        """
        m = self.model
        if not (m.img_l_set and m.net_set):
            raise RuntimeError("model needs an image and a net")
        boxes = np.asarray(boxes, np.int32)
        values = np.asarray(values, np.float32)
        self._last_table = (boxes, values, int(count))
        table = m._dev_table(boxes, values, count)
        if win_args is not None:
            rgb, out_ab, win, _hints = m._click_tbl_win(
                m._dev_l_net, m._dev_l_mc, *m._dev_window(*win_args), *table)
            rgb, frame = m._keep(rgb), win
        else:
            rgb, out_ab, _hints = m._click_tbl(m._dev_l_net, m._dev_l_mc,
                                               *table)
            win, frame = None, rgb
        # start the host copy of the would-be display frame now, so a later
        # latest() only waits on a transfer that is already under way
        finish = graphs.read_async(frame)
        self._seq += 1
        self.frames_submitted += 1
        self._inflight.append((self._seq, None if win is None else rgb,
                               m._keep(out_ab), finish, win is not None))
        while len(self._inflight) > self.depth:
            self._inflight.popleft()      # stale: never read back
            self.frames_dropped += 1
        return self._seq

    def latest(self):
        """Materialize the NEWEST frame in flight; drop older ones unread.

        Returns (seq, frame_u8), the display frame of the last ``submit``
        (window-size when it was submitted with ``win_args``, else
        net-size), or (last_seq, None) when nothing is in flight. Updates
        the backend's output state and dense hint mirrors to match.
        """
        if not self._inflight:
            return self._seq, None
        while len(self._inflight) > 1:
            self._inflight.popleft()
            self.frames_dropped += 1
        seq, rgb, out_ab, finish, has_win = self._inflight.popleft()
        frame_np = finish()
        self.frames_materialized += 1
        m = self.model
        # dense numpy hint mirrors for the getters and the save surface,
        # rasterized on the host by the native runtime
        from ..api.colorize import ColorizeImageBase
        boxes, values, count = self._last_table
        ab, mask = host.rasterize_hints(boxes, values, count, m.Xd)
        ColorizeImageBase.net_forward(m, ab.transpose(2, 0, 1),
                                      mask.transpose(2, 0, 1))
        m._dev_output_ab = out_ab
        # the net-size frame is already on the host when it IS the display
        # frame, else it stays on the device (read back on first use)
        m.output_rgb = rgb if has_win else frame_np
        m._set_out_ab_()
        return seq, frame_np

    def flush(self):
        """Drop everything in flight without materializing (e.g. the image
        changed under the session)."""
        self.frames_dropped += len(self._inflight)
        self._inflight.clear()
