"""PyQt5 interactive colorization GUI.

Counterpart of ``ideepcolor_tpu/ui/qt_gui.py`` (the reference's Qt front-end,
ref: ui/gui_design.py, ui/gui_draw.py, ui/gui_gamut.py, ui/gui_palette.py,
ui/gui_vis.py) over the port's backends:

  * drawing pad: left-click adds a hint point (gamut-snapped), drag moves it,
    right-click erases, wheel resizes the brush; every edit runs one table
    click that returns the window frame (ref ui/gui_draw.py:272-286,
    321-345);
  * gamut widget: the ab plane at the picked pixel's L with the in-gamut
    mask, click to choose a color (ref ui/gui_gamut.py);
  * palettes: K=9 suggested colors from the distribution model + recently
    used colors (ref ui/gui_palette.py, ui/gui_draw.py:179-193);
  * result pane, gray toggle, save/load/restart, hotkeys R/Q/S/G/L
    (ref ui/gui_design.py:81-170).

The window frame is composed on the model's device, by the window clicks
(``net_forward_table_win`` and, in a dist session,
``net_forward_table_win_suggest``) at the window's exact size. Image files
are decoded by the port's codec, and the window, gray and load-size images
are made by the port's copies of OpenCV's INTER_CUBIC resize and RGB2GRAY,
so the GUI needs no OpenCV.

This module requires PyQt5 and a display; everything testable headlessly
lives in ui/control.py and the api/engine layers.
"""

from __future__ import annotations

import datetime
import glob
import os
import sys

import numpy as np
import torch

try:
    from PyQt5.QtCore import Qt, QPoint, QSize, QTimer, pyqtSignal
    from PyQt5.QtGui import QColor, QImage, QPainter, QPen
    from PyQt5.QtWidgets import (
        QApplication, QCheckBox, QFileDialog, QGroupBox,
        QHBoxLayout, QMainWindow, QPushButton, QVBoxLayout, QWidget)
except ImportError as e:  # pragma: no cover - import-gated
    raise ImportError(
        "PyQt5 is required for the GUI; the headless API "
        "(ideepcolor_tpu_torch.api) works without it") from e

from ..data import lab_gamut
from ..engine import pipeline as P
from ..ops.hints import MAX_HINTS
from ..ops.resize import cubic_resize_matrix_np, resize_u8_cubic
from ..ui.control import UIControl
from ..utils.imageio import encode_png, read_image, rgb_to_gray_u8


def _np2qimage(im: np.ndarray) -> QImage:
    im = np.ascontiguousarray(im)
    h, w = im.shape[:2]
    return QImage(im.tobytes(), w, h, 3 * w, QImage.Format_RGB888)


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


class GUIDraw(QWidget):
    """Drawing pad (ref ui/gui_draw.py:19-351)."""

    update_color = pyqtSignal(str)
    update_gamut = pyqtSignal(float)
    suggest_colors = pyqtSignal(object)
    used_colors = pyqtSignal(object)
    update_ab = pyqtSignal(object)
    update_result = pyqtSignal(object)

    def __init__(self, model, dist_model=None, load_size=256, win_size=512,
                 async_drag=True):
        super().__init__()
        self.model = model
        self.dist_model = dist_model
        self.device = model.device
        # drag pipelining: motion events submit async table clicks and one
        # fetch per event-loop cycle paints the newest completed frame
        # (stale in-flight frames are dropped unread — engine/interactive)
        self.async_drag = async_drag
        self._async = None
        self._fetch_scheduled = False
        self.win_size = win_size
        self.load_size = load_size
        self.setFixedSize(win_size, win_size)
        self.uiControl = UIControl(win_size=win_size, load_size=load_size)
        self.result = None
        self.user_color = (128, 128, 128)
        self.color = self.user_color
        self.use_gray = True
        self.ui_mode = 'none'
        self.image_loaded = False
        self.pos = None
        self.brushWidth = 2.0
        self.scale = win_size / float(load_size)
        self.image_file = None
        self.method = 'with_dist'
        from ..utils.profiling import StageTimer
        self.timer = StageTimer()      # per-stage click latency record

    # ---- image IO ----
    def init_result(self, image_file):
        self.read_image(image_file)
        self.reset()

    def get_batches(self, img_dir):
        """Batch annotation mode over a directory
        (ref ui/gui_draw.py:51-66)."""
        self.img_list = sorted(glob.glob(os.path.join(img_dir, '*.JPEG'))
                               + glob.glob(os.path.join(img_dir, '*.jpg')))
        self.total_images = len(self.img_list)
        if self.total_images:
            self.image_id = 0
            self.init_result(self.img_list[0])

    def nextImage(self):
        self.save_result()
        self.image_id += 1
        if self.image_id == self.total_images:
            print('you have finished all the results')
            sys.exit()
        self.init_result(self.img_list[self.image_id])

    def erase(self):
        self.eraseMode = not getattr(self, 'eraseMode', False)

    def read_image(self, image_file):
        self.image_loaded = True
        self.image_file = image_file
        self.im_full = read_image(image_file)          # (H, W, 3) RGB
        h, w = self.im_full.shape[:2]
        r = self.win_size / float(max(h, w))
        rw, rh = int(round(r * w / 4.0) * 4), int(round(r * h / 4.0) * 4)
        dev = self.device
        src = torch.from_numpy(self.im_full).to(dev)
        win_rgb = resize_u8_cubic(src, (rh, rw))
        self.dw, self.dh = (self.win_size - rw) // 2, (self.win_size - rh) // 2
        self.win_w, self.win_h = rw, rh
        self.uiControl.setImageSize((rw, rh))
        gray = np.repeat(rgb_to_gray_u8(self.im_full)[..., None], 3, axis=2)
        self.gray_win = resize_u8_cubic(torch.from_numpy(gray).to(dev),
                                        (rh, rw)).cpu().numpy()
        load_rgb = resize_u8_cubic(src, (self.load_size, self.load_size))
        self.im_rgb = load_rgb.cpu().numpy()
        # both Lab planes the GUI needs stay on the device: the net-size Lab
        # for pixel lookups (read back on first click, im_lab property) and
        # the window L plane for the window clicks, with the INTER_CUBIC
        # matrices of the ab upsample (ref ui/gui_draw.py:281)
        self._dev_im_lab = P.rgb_to_lab_dev_u8(load_rgb)
        self._im_lab_np = None
        self._dev_l_win = P.rgb_to_lab_dev_u8(win_rgb)[..., :1].contiguous()
        self._l_win_np = None
        self._dev_win_rh = torch.as_tensor(
            cubic_resize_matrix_np(self.load_size, rh), device=dev)
        self._dev_win_rw = torch.as_tensor(
            cubic_resize_matrix_np(self.load_size, rw), device=dev)
        self.brushWidth = 2 * self.scale

        self.model.load_image(image_file)
        self._fetch_scheduled = False
        if self._async is not None:
            self._async.flush()        # in-flight frames show the old image
        if self.dist_model is not None:
            self.dist_model.set_image(self.im_rgb)
            self.predict_color()

    def reset(self):
        self.ui_mode = 'none'
        self.pos = None
        self.result = None
        # the brush returns to the default gray on reset
        # (ref ui/gui_draw.py:145-155 init_color)
        self.user_color = (128, 128, 128)
        self.color = self.user_color
        self.uiControl.reset()
        self.compute_result()
        self.predict_color()
        self.update()

    # host views of the device Lab planes, read back on first use (an image
    # load itself never waits for the device)
    @property
    def im_lab(self):
        if self._im_lab_np is None:
            self._im_lab_np = self._dev_im_lab.cpu().numpy()
        return self._im_lab_np

    @property
    def l_win(self):
        if self._l_win_np is None:
            self._l_win_np = self._dev_l_win[..., 0].cpu().numpy()
        return self._l_win_np

    def _window(self):
        return self._dev_l_win, self._dev_win_rh, self._dev_win_rw

    # ---- geometry ----
    def scale_point(self, pnt):
        x = int((pnt.x() - self.dw) / float(self.win_w) * self.load_size)
        y = int((pnt.y() - self.dh) / float(self.win_h) * self.load_size)
        return x, y

    def valid_point(self, pnt):
        if (pnt.x() >= self.dw and pnt.y() >= self.dh
                and pnt.x() < self.win_size - self.dw
                and pnt.y() < self.win_size - self.dh):
            return QPoint(int(pnt.x()), int(pnt.y()))
        return None

    # ---- color picking / suggestions ----
    def calibrate_color(self, c, pos):
        # one color, snapped on the host CPU: the card's snap is a captured
        # graph of 20 fixed iterations of about 107 tiny kernels, slower per
        # pick than the host's loop, which stops when the color converges
        # (chip_smoke.py phase 19 times both; a click snaps twice)
        x, y = self.scale_point(pos)
        snap = lab_gamut.snap_ab(self.im_lab[y, x, 0],
                                 np.array(c, np.uint8), device="cpu")
        return tuple(int(v) for v in snap)

    def _can_fuse_suggest(self) -> bool:
        """True when the next click can take the click+suggest program: a
        dist session, table capacity left (the click may add one edit), the
        per-image dist map and the previous frame on the device."""
        return (self.dist_model is not None and self.image_loaded
                and len(self.uiControl.userEdits) < MAX_HINTS
                and getattr(self.model, "_click_tbl_win_suggest",
                            None) is not None
                and getattr(self.dist_model, "_dev_dist", None) is not None
                and (self.model._dev_output_rgb is not None
                     or self.model._output_rgb_np is not None))

    def change_color(self, pos=None, defer_suggest=False):
        if pos is None:
            return
        x, y = self.scale_point(pos)
        self.update_gamut.emit(float(self.im_lab[y, x, 0]))
        if not defer_suggest:       # fused clicks emit from compute_result
            rgb_colors = self.suggest_color(h=y, w=x, K=9)
            if rgb_colors is not None:
                rgb_colors[-1, :] = 0.5
                self.suggest_colors.emit(rgb_colors)
        used = self.uiControl.used_colors()
        self.used_colors.emit(used)
        snap_color = self.calibrate_color(self.user_color, pos)
        self.update_ab.emit(np.array(snap_color, np.uint8))

    def suggest_color(self, h, w, K=5):
        if self.dist_model is not None and self.image_loaded:
            ab, _conf = self.dist_model.get_ab_reccs(
                h=h, w=w, K=K, N=25000, return_conf=True)
            L = np.tile(self.im_lab[h, w, 0], (K, 1))
            from ..api.colorize import lab2rgb_transpose
            lab = np.concatenate((L, ab), axis=1).T[:, :, None]  # 3xKx1
            colors_rgb = lab2rgb_transpose(
                lab[:1], lab[1:], device=self.device).reshape(K, 3) / 255.0
            cur = self.model.get_img_forward()[h, w][None] / 255.0
            return np.concatenate([cur, colors_rgb], axis=0)
        return None

    def set_color(self, c_rgb):
        self.user_color = tuple(int(v) for v in c_rgb)
        snap = self.calibrate_color(self.user_color, self.pos)
        self.color = snap
        self.update_color.emit('background-color: rgb(%d,%d,%d)' % snap)
        self.uiControl.update_color(snap, self.user_color)
        self.compute_result()

    def predict_color(self):
        if self.dist_model is None or not self.image_loaded:
            return
        # fast path: hint table + device rasterize, no readback of the map
        # (the regression return is discarded here, as in the reference)
        if (hasattr(self.dist_model, "predict_dist_table")
                and len(self.uiControl.userEdits) <= MAX_HINTS):
            boxes, vals, n = self.uiControl.hint_table()
            if self.dist_model.predict_dist_table(boxes, vals, n) != -1:
                return
        im, mask = self.uiControl.get_input()
        from ..api.colorize import rgb2lab_transpose
        im_lab = rgb2lab_transpose(im, device=self.device)
        self.dist_model.net_forward(im_lab[1:],
                                    (mask > 0).transpose(2, 0, 1))

    # ---- interaction ----
    def update_ui(self, move_point=True):
        if self.ui_mode == 'none':
            return False
        is_predict = False
        snap = self.calibrate_color(self.user_color, self.pos)
        self.color = snap
        self.update_color.emit('background-color: rgb(%d,%d,%d)' % snap)
        if self.ui_mode == 'point':
            if move_point:
                self.uiControl.movePoint(
                    (self.pos.x(), self.pos.y()), snap, self.user_color,
                    self.brushWidth)
            else:
                self.user_color, self.brushWidth, is_new = \
                    self.uiControl.addPoint(
                        (self.pos.x(), self.pos.y()), snap,
                        self.user_color, self.brushWidth)
                if is_new:
                    is_predict = True
        if self.ui_mode == 'erase':
            if self.uiControl.erasePoint((self.pos.x(), self.pos.y())):
                is_predict = True
        return is_predict

    def _show(self, win):
        """Paint a window frame and keep the hint mirrors of its click."""
        self.result = np.ascontiguousarray(win[:self.win_h, :self.win_w])
        self.im_ab0 = self.model.input_ab
        self.im_mask0 = self.model.input_mask
        self.update_result.emit(self.result)

    def compute_result(self, suggest_pos=None):
        from ..api.colorize import rgb2lab_transpose
        # the table click ships the hint table, K1 rasterizes it on the
        # device and the window frame comes back from the same program; the
        # dense reference-parity path serves backends without a table
        # program and more edits than the table holds
        self._t_click = self.timer.stage("click_to_frame")
        self._t_click.__enter__()
        if suggest_pos is not None \
                and len(self.uiControl.userEdits) <= MAX_HINTS:
            # click+suggest: the window frame AND the suggestion palette
            # from one program (dist sessions)
            boxes, vals, n = self.uiControl.hint_table()
            sx, sy = self.scale_point(suggest_pos)
            out = self.model.net_forward_table_win_suggest(
                boxes, vals, n, *self._window(), self.dist_model, sy, sx,
                K=9)
            if not (np.isscalar(out) and out == -1):
                win, colors = out
                self._show(win)
                colors = np.asarray(colors, np.float64)
                colors[-1, :] = 0.5
                self.suggest_colors.emit(colors)
                self._t_click.__exit__(None, None, None)
                self.update()
                return
            # the click+suggest program is unavailable after all: emit the
            # deferred suggestion the unfused way, then recompute below
            rgb_colors = self.suggest_color(h=sy, w=sx, K=9)
            if rgb_colors is not None:
                rgb_colors[-1, :] = 0.5
                self.suggest_colors.emit(rgb_colors)
        if len(self.uiControl.userEdits) > MAX_HINTS:
            # more edits than table slots: don't build the table at all —
            # the dense parity path below rasterizes ALL of them
            # (silently dropping the overflow would diverge from the
            # reference's draw-every-edit semantics,
            # ref ui/ui_control.py:177-187)
            n = -1
            win = -1
        else:
            boxes, vals, n = self.uiControl.hint_table()
            win = self.model.net_forward_table_win(boxes, vals, n,
                                                   *self._window())
        if not (np.isscalar(win) and win == -1):
            self._show(win)
            self._t_click.__exit__(None, None, None)
            self.update()
            return
        out = -1
        if n == len(self.uiControl.userEdits):
            out = self.model.net_forward_table(boxes, vals, n)
        if np.isscalar(out) and out == -1:
            im, mask = self.uiControl.get_input()
            im_lab = rgb2lab_transpose(im, device=self.device)
            self.model.net_forward(im_lab[1:],
                                   (mask > 0.0).transpose(2, 0, 1))
        # INTER_CUBIC ab upsample to the window + window-L fusion + K2,
        # by the same cubic matrices as the window clicks
        self._show(P.fullres_fuse(self._dev_l_win, self.model._dev_output_ab,
                                  self._dev_win_rh, self._dev_win_rw)
                   .cpu().numpy())
        self._t_click.__exit__(None, None, None)
        self.update()

    def save_result(self):
        """Session dump, reference format (ref ui/gui_draw.py:222-244):
        im_l/im_ab/im_mask npys + input/result PNGs in a timestamped dir."""
        path, _ = os.path.splitext(os.path.abspath(self.image_file))
        suffix = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
        save_path = "_".join([path, self.method, suffix])
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, 'im_l.npy'), self.model.img_l)
        np.save(os.path.join(save_path, 'im_ab.npy'), self.im_ab0)
        np.save(os.path.join(save_path, 'im_mask.npy'), self.im_mask0)
        _write_png(os.path.join(save_path, 'input_mask.png'),
                   self.im_mask0[0].astype(np.uint8) * 255)
        _write_png(os.path.join(save_path, 'ours.png'), self.result)
        _write_png(os.path.join(save_path, 'ours_fullres.png'),
                   self.model.get_img_fullres())
        _write_png(os.path.join(save_path, 'input_fullres.png'),
                   self.model.get_input_img_fullres())
        _write_png(os.path.join(save_path, 'input.png'),
                   self.model.get_input_img())
        _write_png(os.path.join(save_path, 'input_ab.png'),
                   self.model.get_sup_img())
        print('saved result to <%s>' % save_path)
        return save_path

    def load_image(self):
        img_path, _ = QFileDialog.getOpenFileName(
            self, 'load an input image')
        if img_path:
            self.init_result(img_path)

    def enable_gray(self):
        self.use_gray = not self.use_gray
        self.update()

    # ---- Qt events ----
    def paintEvent(self, event):
        painter = QPainter(self)
        painter.fillRect(event.rect(), QColor(49, 54, 49))
        im = self.gray_win if (self.use_gray or self.result is None) \
            else self.result
        if im is not None:
            painter.drawImage(self.dw, self.dh, _np2qimage(im))
        # draw hint markers
        for ue in self.uiControl.userEdits:
            w = max(3, int(ue.width))
            c = ue.color
            pen = Qt.black if sum(v * v for v in c) > \
                sum((255 - v) ** 2 for v in c) else Qt.white
            painter.setPen(QPen(pen, 1))
            painter.setBrush(QColor(*c))
            painter.drawRoundedRect(ue.pnt[0] - w, ue.pnt[1] - w,
                                    1 + 2 * w, 1 + 2 * w, 2, 2)
        painter.end()

    def mousePressEvent(self, event):
        pos = self.valid_point(event.pos())
        if pos is None:
            return
        self.pos = pos
        if event.button() == Qt.LeftButton:
            self.ui_mode = 'point'
            # dist sessions: fold the suggestion chain into the click's
            # program when it can run; otherwise reference order (suggest,
            # then recompute)
            fused = self._can_fuse_suggest()
            self.change_color(pos, defer_suggest=fused)
            self.update_ui(move_point=False)
            self.compute_result(suggest_pos=pos if fused else None)
        elif event.button() == Qt.RightButton:
            self.ui_mode = 'erase'
            self.update_ui(move_point=False)
            self.compute_result()

    def mouseMoveEvent(self, event):
        self.pos = self.valid_point(event.pos())
        if self.pos is not None and self.ui_mode == 'point':
            self.update_ui(move_point=True)
            if not self._submit_async():
                self.compute_result()

    # ---- pipelined drag (engine/interactive) ----
    def _async_session(self):
        if not self.async_drag:
            return None
        if self._async is None:
            from ..engine.interactive import InteractiveSession
            try:
                self._async = InteractiveSession(self.model)
            except ValueError:        # backend without table programs
                self.async_drag = False
                return None
        return self._async

    def _submit_async(self) -> bool:
        """Dispatch the current edit state without blocking; schedule one
        fetch per event-loop cycle. Returns False when the drag must take
        the synchronous path (async off, or table overflow)."""
        sess = self._async_session()
        if sess is None or len(self.uiControl.userEdits) > MAX_HINTS:
            return False
        boxes, vals, n = self.uiControl.hint_table()
        sess.submit(boxes, vals, n, self._window())
        if not self._fetch_scheduled:
            self._fetch_scheduled = True
            QTimer.singleShot(0, self._fetch_async)
        return True

    def _fetch_async(self):
        self._fetch_scheduled = False
        if self._async is None:
            return
        _seq, win = self._async.latest()
        if win is None:
            return
        self._show(win)
        self.update()

    def wheelEvent(self, event):
        d = event.angleDelta().y() / 120
        self.brushWidth = min(4.05 * self.scale,
                              max(0, self.brushWidth + d * self.scale))
        self.update_ui(move_point=True)
        self.update()

    def sizeHint(self):
        return QSize(self.win_size, self.win_size)


class GUIGamut(QWidget):
    """ab-plane color picker at fixed L (ref ui/gui_gamut.py). The gamut
    mask and the color conversions run on ``device`` (the card unless
    "cpu")."""

    update_color = pyqtSignal(object)

    def __init__(self, gamut_size=110, device=None):
        super().__init__()
        self.gamut_size = gamut_size
        self.win_size = gamut_size * 2
        self.setFixedSize(self.win_size, self.win_size)
        self.ab_grid = lab_gamut.abGrid(gamut_size=gamut_size, D=1,
                                        device=device)
        self.device = self.ab_grid.device
        self.reset()

    def set_gamut(self, l_in=50):
        self.l_in = l_in
        self.colors_mask, self.mask = self.ab_grid.update_gamut(l_in=l_in)
        self.update()

    def set_ab(self, color):
        self.color = color
        self.lab = lab_gamut.rgb2lab_1d(np.asarray(color), device=self.device)
        x, y = self.ab_grid.ab2xy(self.lab[1], self.lab[2])
        self.pos = QPoint(int(x), int(y))
        self.update()

    def is_valid_point(self, pos):
        if pos is None:
            return False
        x, y = pos.x(), pos.y()
        if 0 <= x < self.win_size and 0 <= y < self.win_size:
            return bool(self.mask[y, x])
        return False

    def update_ui(self, pos):
        self.pos = pos
        a, b = self.ab_grid.xy2ab(pos.x(), pos.y())
        L = float(self.l_in)
        color = lab_gamut.lab2rgb_1d(np.array([L, a, b]), clip=True,
                                     dtype='uint8', device=self.device)
        self.emit_color(color)
        self.update()

    def emit_color(self, color):
        self.update_color.emit(color)

    def paintEvent(self, event):
        painter = QPainter(self)
        painter.fillRect(event.rect(), Qt.white)
        if getattr(self, 'colors_mask', None) is not None:
            painter.drawImage(0, 0, _np2qimage(self.colors_mask))
        if getattr(self, 'pos', None) is not None:
            painter.setPen(QPen(Qt.gray, 3))
            w = 5
            painter.drawEllipse(self.pos.x() - w, self.pos.y() - w,
                                2 * w, 2 * w)
        painter.end()

    def mousePressEvent(self, event):
        if event.button() == Qt.LeftButton and self.is_valid_point(
                event.pos()):
            self.update_ui(event.pos())
            self.mouseClicked = True

    def mouseMoveEvent(self, event):
        # drag-to-pick only while the button is held — hovering must not
        # change the color (ref ui/gui_gamut.py:78-86)
        if self.mouseClicked and self.is_valid_point(event.pos()):
            self.update_ui(event.pos())

    def mouseReleaseEvent(self, event):
        self.mouseClicked = False

    def reset(self):
        self.colors_mask = None
        self.mask = None
        self.pos = None
        self.l_in = 50
        self.mouseClicked = False


class GUIPalette(QWidget):
    """Grid of selectable colors (ref ui/gui_palette.py)."""

    update_color = pyqtSignal(object)

    def __init__(self, grid_sz=(6, 3)):
        super().__init__()
        self.grid_sz = grid_sz
        self.border = 6
        self.win_w = grid_sz[0] * 20 + (grid_sz[0] + 1) * self.border
        self.win_h = grid_sz[1] * 20 + (grid_sz[1] + 1) * self.border
        self.setFixedSize(self.win_w, self.win_h)
        self.colors = None
        self.id = -1
        self.mouseClicked = False

    def set_colors(self, colors):
        if colors is not None:
            # cap to the grid capacity (ref ui/gui_palette.py:22)
            n = self.grid_sz[0] * self.grid_sz[1]
            self.colors = (np.clip(colors[:n], 0, 1) * 255).astype(np.uint8)
            self.id = -1
            self.update()

    def paintEvent(self, event):
        painter = QPainter(self)
        painter.fillRect(event.rect(), Qt.white)
        if self.colors is not None:
            for n, c in enumerate(self.colors):
                ca = QColor(int(c[0]), int(c[1]), int(c[2]), 255)
                painter.setPen(QPen(Qt.black, 1))
                painter.setBrush(ca)
                x = (n % self.grid_sz[0])
                y = (n // self.grid_sz[0])
                px = self.border + x * (20 + self.border)
                py = self.border + y * (20 + self.border)
                if n == self.id:        # selected color renders as a circle
                    painter.drawEllipse(px, py, 20, 20)
                else:
                    painter.drawRoundedRect(px, py, 20, 20, 2, 2)
        painter.end()

    def _sel_id(self, pos):
        x = (pos.x() - self.border) // (20 + self.border)
        y = (pos.y() - self.border) // (20 + self.border)
        i = int(y * self.grid_sz[0] + x)
        if self.colors is not None and 0 <= i < len(self.colors):
            return i
        return None

    def _pick(self, pos):
        i = self._sel_id(pos)
        if i is not None:
            self.id = i
            self.update_color.emit(self.colors[i])
            self.update()

    def mousePressEvent(self, event):
        if event.button() == Qt.LeftButton:
            self._pick(event.pos())
            self.mouseClicked = True

    def mouseMoveEvent(self, event):
        # drag across the palette keeps picking (ref ui/gui_palette.py:84-86)
        if self.mouseClicked:
            self._pick(event.pos())

    def mouseReleaseEvent(self, event):
        self.mouseClicked = False

    def reset(self):
        self.colors = None
        self.id = -1
        self.mouseClicked = False
        self.update()


class GUI_VIS(QWidget):
    """Result pane (ref ui/gui_vis.py)."""

    def __init__(self, win_size=512):
        super().__init__()
        self.win_size = win_size
        self.setFixedSize(win_size, win_size)
        self.result = None

    def update_result(self, result):
        self.result = result
        self.update()

    def paintEvent(self, event):
        painter = QPainter(self)
        painter.fillRect(event.rect(), QColor(49, 54, 49))
        if self.result is not None:
            h, w = self.result.shape[:2]
            dw, dh = (self.win_size - w) // 2, (self.win_size - h) // 2
            painter.drawImage(dw, dh, _np2qimage(self.result))
        painter.end()

    def reset(self):
        self.result = None
        self.update()


class GUIDesign(QMainWindow):
    """Main window: layout + signal wiring + hotkeys
    (ref ui/gui_design.py:10-172)."""

    def __init__(self, color_model, dist_model=None, img_file=None,
                 load_size=256, win_size=512, save_all=True):
        super().__init__()
        self.setWindowTitle('ideepcolor-tpu-torch: interactive deep '
                            'colorization')
        main = QWidget()
        self.setCentralWidget(main)
        layout = QHBoxLayout(main)

        # left column: gamut + palettes
        left = QVBoxLayout()
        gamut_box = QGroupBox("ab color gamut")
        gl = QVBoxLayout(gamut_box)
        self.gamutWidget = GUIGamut(gamut_size=110,
                                    device=color_model.device)
        gl.addWidget(self.gamutWidget)
        left.addWidget(gamut_box)

        sug_box = QGroupBox("suggested colors")
        sl = QVBoxLayout(sug_box)
        self.customPalette = GUIPalette(grid_sz=(10, 1))
        sl.addWidget(self.customPalette)
        left.addWidget(sug_box)

        used_box = QGroupBox("recently used colors")
        ul = QVBoxLayout(used_box)
        self.usedPalette = GUIPalette(grid_sz=(10, 1))
        ul.addWidget(self.usedPalette)
        left.addWidget(used_box)
        layout.addLayout(left)

        # center: drawing pad + buttons
        center = QVBoxLayout()
        draw_box = QGroupBox("Drawing Pad")
        dl = QVBoxLayout(draw_box)
        self.drawWidget = GUIDraw(color_model, dist_model,
                                  load_size=load_size, win_size=win_size)
        dl.addWidget(self.drawWidget)
        center.addWidget(draw_box)

        btns = QHBoxLayout()
        self.bGray = QCheckBox("&Gray")
        self.bGray.setChecked(True)
        self.bLoad = QPushButton('&Load')
        self.bSave = QPushButton("&Save")
        self.bRestart = QPushButton("&Restart")
        self.bQuit = QPushButton("&Quit")
        for b in (self.bGray, self.bLoad, self.bSave, self.bRestart,
                  self.bQuit):
            btns.addWidget(b)
        center.addLayout(btns)
        layout.addLayout(center)

        # right: result
        res_box = QGroupBox("Result")
        rl = QVBoxLayout(res_box)
        self.visWidget = GUI_VIS(win_size=win_size)
        rl.addWidget(self.visWidget)
        layout.addWidget(res_box)

        # signal wiring (ref ui/gui_design.py:81-100)
        self.drawWidget.update_gamut.connect(self.gamutWidget.set_gamut)
        self.drawWidget.update_ab.connect(self.gamutWidget.set_ab)
        self.drawWidget.suggest_colors.connect(self.customPalette.set_colors)
        self.drawWidget.used_colors.connect(self.usedPalette.set_colors)
        self.drawWidget.update_result.connect(self.visWidget.update_result)
        self.gamutWidget.update_color.connect(self.drawWidget.set_color)
        self.customPalette.update_color.connect(self.drawWidget.set_color)
        self.usedPalette.update_color.connect(self.drawWidget.set_color)
        # palette picks also move the gamut cursor
        # (ref ui/gui_design.py:96,100)
        self.customPalette.update_color.connect(self.gamutWidget.set_ab)
        self.usedPalette.update_color.connect(self.gamutWidget.set_ab)
        self.bGray.toggled.connect(self.drawWidget.enable_gray)
        self.bRestart.clicked.connect(self.reset)
        self.bQuit.clicked.connect(self.quit)
        self.bLoad.clicked.connect(self.load)
        self.bSave.clicked.connect(self.save)

        self.start_t = datetime.datetime.now()
        if img_file is not None:
            self.drawWidget.init_result(img_file)

    def reset(self):
        self.drawWidget.reset()
        self.gamutWidget.reset()
        self.customPalette.reset()
        self.usedPalette.reset()
        self.visWidget.reset()

    def save(self):
        print('time spent = %s' % (datetime.datetime.now() - self.start_t))
        if self.drawWidget.timer.samples:
            print(self.drawWidget.timer.report())
        self.drawWidget.save_result()

    def load(self):
        self.drawWidget.load_image()

    def quit(self):
        print('time spent = %s' % (datetime.datetime.now() - self.start_t))
        if self.drawWidget.timer.samples:
            print(self.drawWidget.timer.report())
        QApplication.quit()

    def keyPressEvent(self, event):
        if event.key() == Qt.Key_R:
            self.reset()
        elif event.key() == Qt.Key_Q:
            self.save()
            self.quit()
        elif event.key() == Qt.Key_S:
            self.save()
        elif event.key() == Qt.Key_G:
            self.bGray.toggle()
        elif event.key() == Qt.Key_L:
            self.load()
