"""ColorizeImageBase-compatible API over the PyTorch/CUDA engine.

Counterpart of ``ideepcolor_tpu/api/colorize.py``: ``ColorizeImageBase``,
``ColorizeImageJax`` as :class:`ColorizeImageTorch` and
``ColorizeImageJaxDist`` as :class:`ColorizeImageTorchDist`, the
reference's own names for these backends, and the Caffe family
(``ColorizeImageJaxCaffe``, ``...CaffeGlobDist``, ``...CaffeDist``) as
:class:`ColorizeImageTorchCaffe`, :class:`ColorizeImageTorchCaffeGlobDist`
and :class:`ColorizeImageTorchCaffeDist`. Same public contract: numpy
channel-first arrays in, uint8 (H, W, 3) frames out, the same method names,
state fields, -1 sentinels and shape checks.

Behind it, the image state lives on ``device`` (the card unless the caller
passes ``device="cpu"``), and every frame is composed by kernel K2; the
table programs rasterize their hints with kernel K1. On the card every click
program is a captured CUDA graph (``engine.graphs``): a click stages its
hint table, count and pixel through one pinned buffer, replays one graph,
copies out the outputs it keeps (the graph overwrites its own on the next
click) and reads back what it returns. On the CPU the programs are the plain
functions. ``prep_net(dtype="bfloat16")`` is the serving precision; f32
parity is the default.

The numpy hint mirrors of every table click (``input_ab``, ``input_mask``)
are rasterized on the host from the click's table by the native host
runtime (``ops.host``); K1's planes are never read back for them. The
``*_host`` clicks compose their window frame on the host from the net frame
(:func:`compose_window_host`), and the ``abq`` clicks read back only the
uint8-quantized ab and compose the net frame on the host
(:func:`compose_net_abq_host`); ``IDEEPCOLOR_NET_CLICK`` chooses between
``rgb`` and ``abq[_half]`` where a caller asks (:func:`net_click_mode`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..engine import graphs
from ..engine import pipeline as P
from ..data.color_bins import get_bins
from ..models import caffe_net
from ..models.siggraph import (SIGGRAPHGenerator, init_state_dict,
                               load_state_dict_file)
from ..ops import colorspace as cs
from ..ops import host
from ..ops import quantize
from ..ops.cuda import colorspace_kernel as k2
from ..ops.quantize import make_pts_grid
from ..ops.resize import (cubic_resize_matrix_np, linear_resize_matrix_np,
                          nearest_resize_matrix_np, resize_u8_half_pixel,
                          zoom_with_matrices)
from ..utils.imageio import read_image


def _to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) uint8 or float-in-[0,1] RGB -> (H,W,3) Lab."""
    if rgb.dtype == torch.uint8:
        return P.rgb_to_lab_dev_u8(rgb)
    return cs.rgb_to_lab(rgb.to(torch.float32))


def rgb2lab_transpose(img_rgb, device=None) -> np.ndarray:
    """(H,W,3) RGB (uint8, or float in [0,1]) -> (3,H,W) Lab."""
    img = np.asarray(img_rgb)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H,W,3) RGB image, got {img.shape}")
    t = torch.as_tensor(np.ascontiguousarray(img),
                        device=resolve_device(device))
    return _to_lab(t).permute(2, 0, 1).cpu().numpy()


def lab2rgb_transpose(img_l, img_ab, device=None) -> np.ndarray:
    """(1,H,W) L + (2,H,W) ab -> (H,W,3) uint8, composed by K2."""
    dev = resolve_device(device)
    l = torch.as_tensor(np.asarray(img_l, np.float32), device=dev)
    ab = torch.as_tensor(np.asarray(img_ab, np.float32), device=dev)
    return k2.lab_to_rgb_u8_hwc(l[0], ab[0], ab[1]).cpu().numpy()


def compose_window_host(net_rgb_u8, l_win_pad, rh, rw) -> np.ndarray:
    """The window-size display frame composed on the host from the net-size
    frame, by the native host runtime: the same chain as the device window
    clicks (requantized uint8 ab -> resize by the matrices -> truncating
    Lab -> uint8 RGB), planar end to end, with the banded zoom.

    net_rgb_u8 (S,S,3) uint8; l_win_pad (Hw,Ww,1) float L plane; rh (Hw,S)
    / rw (Ww,S) float32 resize matrices -> (Hw,Ww,3) uint8."""
    a0, b0 = host.rgb2lab_u8_ab(net_rgb_u8)
    a, b = host.zoom2_matrices(a0, b0, rh, rw)
    return host.lab2rgb_u8_planar(
        np.asarray(l_win_pad, np.float32)[..., 0], a, b)


def net_click_mode() -> str:
    """The session click's transport, ``IDEEPCOLOR_NET_CLICK``: ``rgb``
    (the default: the frame composed on the device and read back), ``abq``
    (the uint8-quantized ab read back, 2/3 of the frame's bytes, and the
    frame composed on the host) or ``abq_half`` (the payload 2x2-averaged
    too, 1/6 of the bytes). Any other value is ``rgb``."""
    mode = os.environ.get("IDEEPCOLOR_NET_CLICK", "rgb")
    return mode if mode in ("abq", "abq_half", "rgb") else "rgb"


_ABQ_ZOOM_CACHE: dict = {}


def compose_net_abq_host(l_net_hw, abq, half=False) -> np.ndarray:
    """The net-size display frame composed on the host from an abq click's
    payload (``engine.pipeline.make_table_click_abq_program``): dequantize
    the uint8 ab, cubic-upsample it 2x when the payload was averaged
    (``half``; the banded zoom), then the native planar Lab -> uint8 RGB.
    l_net_hw (S,S) float L plane (the API keeps one readback of it per
    image, ``_host_l_net``); abq (S,S,2) or (S/2,S/2,2) uint8. The upsample
    matrices are cached by size, at most 8 pairs."""
    a = abq[..., 0].astype(np.float32) * (1.0 / P.AB_Q_SCALE) - P.AB_CLIP
    b = abq[..., 1].astype(np.float32) * (1.0 / P.AB_Q_SCALE) - P.AB_CLIP
    if half:
        src, dst = abq.shape[0], l_net_hw.shape[0]
        m = _ABQ_ZOOM_CACHE.get((src, dst))
        if m is None:
            if len(_ABQ_ZOOM_CACHE) >= 8:
                _ABQ_ZOOM_CACHE.pop(next(iter(_ABQ_ZOOM_CACHE)))
            # read only by the zoom: one array serves rows and columns
            m = _ABQ_ZOOM_CACHE[(src, dst)] = cubic_resize_matrix_np(src, dst)
        a, b = host.zoom2_matrices(a, b, m, m)
    return host.lab2rgb_u8_planar(np.asarray(l_net_hw, np.float32), a, b)


class ColorizeImageBase:
    """Image state + hint normalization + full-res reconstruction.

    State fields keep the reference's channel-first numpy conventions; the
    tensors the frames are made from stay on ``self.device``.
    """

    def __init__(self, Xd: int = 256, Xfullres_max: int = 10000,
                 device=None):
        self.device = resolve_device(device)
        self.Xd = Xd
        self.img_l_set = False
        self.net_set = False
        self.Xfullres_max = Xfullres_max
        self.img_just_set = False
        self.output_rgb = None
        self._dev_output_ab = None
        self._fullres_hw = None
        self._stage = None

    def _to_dev(self, arr, dtype=None) -> torch.Tensor:
        """A numpy array (copied up) or a tensor (moved if it lies
        elsewhere) on ``self.device``."""
        if not isinstance(arr, torch.Tensor):
            arr = np.ascontiguousarray(arr)
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _dev_pts(self) -> torch.Tensor:
        """The ``pts_in_hull`` grid of the suggestion programs, made on the
        device once (it never changes after construction)."""
        p = getattr(self, "_dev_pts_in_hull", None)
        if p is None:
            p = self._dev_pts_in_hull = self._to_dev(self.pts_in_hull,
                                                     torch.float32)
        return p

    # ``output_rgb`` is read back lazily: a click assigns the device tensor,
    # which stays for the next suggest click's current-color row, and the
    # numpy frame is made on the first read (the window clicks, which
    # return the window frame, never read it).
    @property
    def output_rgb(self):
        if self._output_rgb_np is None and self._dev_output_rgb is not None:
            self._output_rgb_np = self._dev_output_rgb.cpu().numpy()
        return self._output_rgb_np

    @output_rgb.setter
    def output_rgb(self, value):
        if isinstance(value, torch.Tensor):
            self._dev_output_rgb, self._output_rgb_np = value, None
        else:
            self._dev_output_rgb, self._output_rgb_np = None, value

    def _frame(self, l: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> np.ndarray:
        """(H,W) L, a, b planes on the device -> (H,W,3) uint8 numpy."""
        return k2.lab_to_rgb_u8_hwc(l, a, b).cpu().numpy()

    # ----- image prep -----
    def load_image(self, input_path: str):
        """Decode the file with the port's codec (PNG natively, other
        formats through OpenCV where it is installed) and load it."""
        self.load_image_array(read_image(input_path))

    def load_image_array(self, im_rgb: np.ndarray):
        """``load_image`` from an in-memory (H,W,3) RGB array of any size:
        the full-res Lab stays on the device and the net-size image is the
        half-pixel bilinear resize (``cv2.resize``'s default) of it."""
        im = np.asarray(im_rgb)
        if im.ndim != 3 or im.shape[-1] != 3:
            raise ValueError(f"expected (H,W,3) RGB image, got {im.shape}")
        src = self._to_dev(im)
        self.img_rgb_fullres = im.copy()
        self._set_img_lab_fullres_(src)
        small = resize_u8_half_pixel(src, (self.Xd, self.Xd))
        self.img_rgb = small.cpu().numpy()
        self.img_l_set = True
        self._set_img_lab_(small)
        self._set_img_lab_mc_()

    def set_image(self, input_image: np.ndarray):
        """The reference contract: ``input_image`` is ALREADY net-sized;
        a mis-sized one raises (use load_image_array for any size)."""
        shape = np.asarray(input_image).shape
        if shape != (self.Xd, self.Xd, 3):
            raise ValueError(
                f"set_image expects a net-sized ({self.Xd},{self.Xd},3) "
                f"image, got {shape}; use load_image_array for "
                f"arbitrary sizes")
        src = self._to_dev(np.asarray(input_image))
        self.img_rgb_fullres = np.asarray(input_image).copy()
        self._set_img_lab_fullres_(src)
        self.img_l_set = True
        self.img_rgb = np.asarray(input_image)
        self._set_img_lab_(src)
        self._set_img_lab_mc_()

    def prep_net(self, *args, **kwargs):
        raise NotImplementedError("implemented by backends")

    # ----- forward -----
    def net_forward(self, input_ab, input_mask):
        """ab (2,Xd,Xd) non-normalized hints; mask (1,Xd,Xd) in {0,1}."""
        if not self.img_l_set:
            print('I need to have an image!')
            return -1
        if not self.net_set:
            print('I need to have a net!')
            return -1
        input_ab = np.asarray(input_ab, np.float32)
        input_mask = np.asarray(input_mask, np.float32)
        if input_ab.shape != (2, self.Xd, self.Xd):
            raise ValueError(
                f"input_ab must be (2,{self.Xd},{self.Xd}) channel-first, "
                f"got {input_ab.shape}")
        if input_mask.shape != (1, self.Xd, self.Xd):
            raise ValueError(
                f"input_mask must be (1,{self.Xd},{self.Xd}), got "
                f"{input_mask.shape}")
        self.input_ab = input_ab
        self.input_ab_mc = (self.input_ab - self.ab_mean) / self.ab_norm
        self.input_mask = input_mask
        self.input_mask_mult = self.input_mask * self.mask_mult
        return 0

    def net_forward_table(self, boxes, values, count):
        """Interactive path: hint table in, frame out.

        boxes (M,4) int32 [y1,x1,y2,x2] inclusive; values (M,2) ab; count
        live hints. K1 rasterizes the table on the device; the numpy hint
        mirrors (``input_ab``, ``input_mask``) are rasterized on the host
        from the same table (:meth:`_set_hint_mirrors`). Backends without a
        table program return -1."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl", None)
        if click is None:
            return -1
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        rgb, out_ab, _hints = click(self._dev_l_net, self._dev_l_mc,
                                    *self._dev_table(boxes, values, count))
        self._set_outputs(rgb, out_ab)
        return self.output_rgb

    def net_forward_table_abq(self, boxes, values, count, half=False):
        """The table click whose readback is only the uint8-quantized ab
        prediction ((S,S,2), 2/3 of the frame's bytes; (S/2,S/2,2), 1/6,
        with ``half``): the frame is composed on the host
        (:func:`compose_net_abq_host`, from one L readback per image) and
        differs from the device compose by the ab quantization step (most
        pixels by 1 LSB or none, a few by more where the sRGB curve is
        steep; ``half`` also smooths the chroma across hint edges).
        ``output_ab`` is the requantized ab of that
        frame, extracted on the host; its device copy is uploaded only when
        a full-res getter reads it (``_dev_output_ab``). -1 without an
        image, a net or an abq program."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl_abq_half" if half
                        else "_click_tbl_abq", None)
        if click is None:
            return -1
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        abq, _hints = click(self._dev_l_mc,
                            *self._dev_table(boxes, values, count))
        rgb = compose_net_abq_host(self._host_l_net(), abq.cpu().numpy(),
                                   half=half)
        self.output_rgb = rgb
        self._set_out_ab_host_(*host.rgb2lab_u8_ab(rgb))
        return self.output_rgb

    def _dev_table(self, boxes, values, count, h=None, w=None):
        """A click's table (and pixel) as its program takes them. On the
        CPU: tensors and Python ints. On the card: the fixed device views of
        this model's ``graphs.TableStage``, refilled by one asynchronous
        copy, so the captured programs read the live count and pixel."""
        pixel = () if h is None else (int(h), int(w))
        if self.device.type != "cuda":
            return (self._to_dev(np.asarray(boxes, np.int32)),
                    self._to_dev(np.asarray(values, np.float32)),
                    int(count)) + pixel
        if pixel and not (0 <= pixel[0] < self.Xd and 0 <= pixel[1] < self.Xd):
            raise IndexError(f"pixel {pixel} outside the {self.Xd}x{self.Xd} "
                             f"net frame")
        st = self._stage
        if st is None:
            st = self._stage = graphs.TableStage(self.device)
        st.put(boxes, values, count, *pixel)
        return (st.boxes, st.values, st.count) + ((st.h, st.w) if pixel
                                                  else ())

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        """An output of a click program that the model holds past the next
        click: on the card a copy, since the captured graph writes its own
        buffers again on every replay."""
        return t.clone() if self.device.type == "cuda" else t

    def _set_hint_mirrors(self, boxes, values, count):
        """The numpy hint mirrors of a click (``input_ab``, ``input_mask``
        and their normalized forms), rasterized on the host from its table
        by the native host runtime: K1's contract, with nothing read back
        from the device. -1 on the sentinel failures."""
        ab, mask = host.rasterize_hints(np.asarray(boxes), np.asarray(values),
                                        int(count), self.Xd)
        return ColorizeImageBase.net_forward(self, ab.transpose(2, 0, 1),
                                             mask.transpose(2, 0, 1))

    def _set_outputs(self, rgb, out_ab):
        self._dev_output_ab = self._keep(out_ab)
        self.output_rgb = self._keep(rgb)  # stays on the device; lazy numpy
        self._set_out_ab_()

    def net_forward_table_win(self, boxes, values, count, l_win_pad, rh, rw):
        """Table click that returns the window-size display frame.

        l_win_pad (Hw, Ww, 1): the window's L plane; rh (Hw, Xd) / rw (Ww,
        Xd): interpolation matrices; tensors on the device, or numpy. The
        net-size frame stays on the device in ``output_rgb`` (read back on
        first use); only the window frame is read back here."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl_win", None)
        if click is None:
            return -1
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        rgb, out_ab, win, _hints = click(
            self._dev_l_net, self._dev_l_mc,
            *self._dev_window(l_win_pad, rh, rw),
            *self._dev_table(boxes, values, count))
        self._set_outputs(rgb, out_ab)
        return win.cpu().numpy()

    def _dev_window(self, l_win_pad, rh, rw):
        return (self._to_dev(l_win_pad, torch.float32),
                self._to_dev(rh, torch.float32),
                self._to_dev(rw, torch.float32))

    def net_forward_table_win_suggest(self, boxes, values, count,
                                      l_win_pad, rh, rw, dist_model,
                                      h, w, K=9, N=25000):
        """Dist-session GUI click: the window frame AND the (K+1, 3)
        suggestion palette for the click pixel (h, w).

        The per-image distribution map of ``dist_model`` (on the device
        since its last predict) feeds the CMF-sample + k-means + Lab->RGB
        palette chain behind the same forward; its random numbers come from
        ``dist_model``'s generator. Returns (win, colors), or -1 when the
        path is not available: no table program, no dist map yet, or no
        previous frame for the palette's current-color row."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl_win_suggest", None)
        dist_dev = getattr(dist_model, "_dev_dist", None)
        if click is None or dist_dev is None:
            return -1
        prev = self._dev_output_rgb
        if prev is None:
            if self._output_rgb_np is None:
                return -1
            prev = self._to_dev(self._output_rgb_np)
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        *table, h_dev, w_dev = self._dev_table(boxes, values, count, h, w)
        rgb, out_ab, win, colors, _hints = click(
            self._dev_l_net, self._dev_l_mc,
            *self._dev_window(l_win_pad, rh, rw), *table,
            dist_dev, h_dev, w_dev, dist_model._dev_pts(), prev,
            dist_model._generator, K=int(K), N=int(N),
            map_div=dist_model.dist_map_div)
        self._set_outputs(rgb, out_ab)
        return win.cpu().numpy(), colors.cpu().numpy()

    def net_forward_table_win_host(self, boxes, values, count,
                                   l_win_pad_np, rh_np, rw_np):
        """The table click with the window frame composed on the host.

        In the default ``rgb`` mode (:func:`net_click_mode`) it reads back
        the device-composed net frame and composes the window from it
        (:func:`compose_window_host`, the reference's own host window
        compose, ref ui/gui_draw.py:280-284); in the ``abq`` modes it takes
        :meth:`net_forward_table_abq` and composes the window from the same
        requantized ab planes. All arguments are host arrays. Returns the
        window frame, or -1."""
        mode = net_click_mode()
        if mode != "rgb" and getattr(self, "_click_tbl_abq", None) \
                is not None:
            out = self.net_forward_table_abq(boxes, values, count,
                                             half=(mode == "abq_half"))
            if isinstance(out, int):
                return -1
            a, b = self._out_ab_np
            aw, bw = host.zoom2_matrices(a, b, rh_np, rw_np)
            return host.lab2rgb_u8_planar(
                np.asarray(l_win_pad_np, np.float32)[..., 0], aw, bw)
        out = self.net_forward_table(boxes, values, count)
        if isinstance(out, int):
            return -1
        return compose_window_host(out, l_win_pad_np, rh_np, rw_np)

    def net_forward_table_suggest_host(self, boxes, values, count,
                                       l_win_pad_np, rh_np, rw_np,
                                       dist_model, h, w, K=9, N=25000):
        """Dist-session GUI click with the window composed on the host: one
        program gives the net frame and the suggestion palette packed into
        one buffer (``pipeline.make_table_click_suggest_program``), read
        back once; the window frame is composed from the net frame
        (:func:`compose_window_host`). Returns (win, colors (K+1,3) float in
        [0,1], the suggestion rows rounded to 1/255), or -1 under the same
        conditions as :meth:`net_forward_table_win_suggest`."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl_suggest", None)
        dist_dev = getattr(dist_model, "_dev_dist", None)
        if click is None or dist_dev is None:
            return -1
        prev = self._dev_output_rgb
        if prev is None:
            if self._output_rgb_np is None:
                return -1
            prev = self._to_dev(self._output_rgb_np)
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        *table, h_dev, w_dev = self._dev_table(boxes, values, count, h, w)
        packed, out_ab, _hints = click(
            self._dev_l_net, self._dev_l_mc, *table, dist_dev, h_dev, w_dev,
            dist_model._dev_pts(), prev, dist_model._generator, K=int(K),
            N=int(N), map_div=dist_model.dist_map_div)
        self._dev_output_ab = self._keep(out_ab)
        packed_np = packed.cpu().numpy()
        rgb_np = packed_np[:self.Xd]
        # both forms of the frame: the numpy one read back with the palette,
        # the device one (a copy: the graph's next replay overwrites
        # ``packed``) for the next click's palette row, with no upload
        self._dev_output_rgb = self._keep(packed[:self.Xd])
        self._output_rgb_np = rgb_np
        self._set_out_ab_()
        colors = packed_np[self.Xd, :int(K) + 1].astype(np.float32) / 255.0
        return compose_window_host(rgb_np, l_win_pad_np, rh_np, rw_np), colors

    def net_forward_fullres(self, input_ab, input_mask):
        """Forward + full-res reconstruction: ``net_forward`` followed by
        ``get_img_fullres``, with one readback (the full-res frame). The
        net-size frame stays on the device in ``output_rgb`` (lazy)."""
        finish = self.net_forward_fullres_async(input_ab, input_mask)
        return finish if finish == -1 else finish()

    def net_forward_fullres_async(self, input_ab, input_mask):
        """Dispatch the dense click and the full-res fusion, start the copy
        of the full-res frame to the host, and return a function without
        arguments that blocks for the frame.

        A serving caller dispatches under its device lock and blocks outside
        it. The function owns its buffers (``graphs.read_async``), so a
        later ``load_image_array`` or click cannot change what it returns.
        -1 on the usual sentinel failures (unset image or net, a backend
        without a dense click program)."""
        if not self.img_l_set or not self.net_set:
            return -1
        if ColorizeImageBase.net_forward(self, input_ab, input_mask) == -1:
            return -1
        out = self._dispatch_click()
        if out is None:
            return -1
        self._set_outputs(*out)
        return self.get_img_fullres_async()

    def _dispatch_click(self):
        """Dispatch the backend's dense click program on the hint mirrors
        (no readback): ``(rgb, out_ab)`` on the device, or None when the
        backend has no such program."""
        return None

    # ----- quality probe -----
    def get_result_PSNR(self, result=-1, return_SE_map=False):
        if np.array(result).flatten()[0] == -1:
            cur_result = self.get_img_forward()
        else:
            cur_result = np.asarray(result).copy()
        SE_map = (1. * self.img_rgb - cur_result) ** 2
        cur_MSE = np.mean(SE_map)
        cur_PSNR = 20 * np.log10(255. / np.sqrt(cur_MSE))
        return (cur_PSNR, SE_map) if return_SE_map else cur_PSNR

    # ----- getters (one device chain each, one readback) -----
    def get_img_forward(self):
        return self.output_rgb

    def get_img_gray(self):
        l = self._dev_l_net[..., 0]
        z = P.zeros_plane(l)
        return self._frame(l, z, z)

    def get_img_gray_fullres(self):
        l = self._dev_l_fullres[..., 0]
        z = P.zeros_plane(l)
        return self._frame(l, z, z)

    def get_img_fullres(self):
        return self._fullres_from_ab(self._dev_output_ab)

    def get_img_fullres_async(self):
        """Dispatch the full-res fusion, start the copy to the host and
        return a function without arguments that blocks for the frame (see
        ``net_forward_fullres_async``)."""
        return graphs.read_async(P.fullres_fuse(
            self._dev_l_fullres, self._dev_output_ab, self._dev_rh,
            self._dev_rw))

    def _fullres_from_ab(self, ab_dev: torch.Tensor) -> np.ndarray:
        return P.fullres_fuse(self._dev_l_fullres, ab_dev, self._dev_rh,
                              self._dev_rw).cpu().numpy()

    def get_input_img_fullres(self):
        return self._fullres_from_ab(
            self._to_dev(self.input_ab.transpose(1, 2, 0)))

    def get_input_img(self):
        ab = self._to_dev(self.input_ab)
        return self._frame(self._dev_l_net[..., 0], ab[0], ab[1])

    def get_img_mask(self):
        l = self._to_dev(100. * (1 - self.input_mask), torch.float32)[0]
        z = P.zeros_plane(l)
        return self._frame(l, z, z)

    def get_img_mask_fullres(self):
        return P.mask_fullres(
            self._to_dev(self.input_mask.transpose(1, 2, 0)),
            self._dev_rh0, self._dev_rw0).cpu().numpy()

    def get_sup_img(self):
        l = self._to_dev(50 * self.input_mask, torch.float32)[0]
        ab = self._to_dev(self.input_ab)
        return self._frame(l, ab[0], ab[1])

    def get_sup_fullres(self):
        planes = self._to_dev(np.concatenate(
            [self.input_mask, self.input_ab], 0).transpose(1, 2, 0))
        return P.sup_fullres(planes, self._dev_rh0,
                             self._dev_rw0).cpu().numpy()

    # ----- private -----
    def _set_img_lab_fullres_(self, src: torch.Tensor):
        """Full-res Lab on the device, plus the exact-size interpolation
        matrices of the full-res getters. An image past Xfullres_max is
        first shrunk by align-corners bilinear, as the JAX package does."""
        H, W = src.shape[:2]
        if H > self.Xfullres_max or W > self.Xfullres_max:
            zf = self.Xfullres_max / max(H, W)
            H, W = int(round(H * zf)), int(round(W * zf))
            src = zoom_with_matrices(
                src, self._to_dev(linear_resize_matrix_np(src.shape[0], H)),
                self._to_dev(linear_resize_matrix_np(src.shape[1], W))
            ).to(src.dtype)
            self.img_rgb_fullres = src.cpu().numpy()
        lab = _to_lab(src)
        self._fullres_hw = (H, W)
        self._dev_lab_fullres = lab
        # contiguous, so K2 reads 4 B/px of L, not a stride-3 channel
        self._dev_l_fullres = lab[..., :1].contiguous()
        self._lab_fullres_np = None
        Xd = self.Xd
        self._dev_rh = self._to_dev(linear_resize_matrix_np(Xd, H))
        self._dev_rw = self._to_dev(linear_resize_matrix_np(Xd, W))
        self._dev_rh0 = self._to_dev(nearest_resize_matrix_np(Xd, H))
        self._dev_rw0 = self._to_dev(nearest_resize_matrix_np(Xd, W))

    def _set_img_lab_(self, src: torch.Tensor):
        lab = _to_lab(src)
        self._dev_lab_net = lab                          # (Xd, Xd, 3)
        self._dev_l_net = lab[..., :1].contiguous()      # (Xd, Xd, 1)
        self._img_lab_np = None
        self._host_l_net_np = None

    def _host_l_net(self) -> np.ndarray:
        """(Xd, Xd) float L plane for the host composes: only the L plane
        is read back, once per image, and kept for the session's clicks
        (the whole Lab mirror serves when something already read it)."""
        if getattr(self, "_img_lab_np", None) is not None:
            return self._img_lab_np[0]
        if getattr(self, "_host_l_net_np", None) is None:
            self._host_l_net_np = self._dev_l_net[..., 0].cpu().numpy()
        return self._host_l_net_np

    def _set_img_lab_mc_(self):
        self._dev_l_mc = P.center_plane(self._dev_lab_net, self.l_mean,
                                        self.l_norm)     # (Xd, Xd, 1)
        self.img_l_set = True
        self._img_lab_mc_np = None

    _set_img_l_ = _set_img_lab_mc_

    @property
    def img_lab_fullres(self):
        if self._fullres_hw is None:
            raise RuntimeError(
                "no image loaded (call load_image/set_image first)")
        if self._lab_fullres_np is None:
            self._lab_fullres_np = (self._dev_lab_fullres.permute(2, 0, 1)
                                    .cpu().numpy())
        return self._lab_fullres_np

    @property
    def img_l_fullres(self):
        return self.img_lab_fullres[[0]]

    @property
    def img_ab_fullres(self):
        return self.img_lab_fullres[1:]

    @property
    def img_lab(self):
        if getattr(self, "_img_lab_np", None) is None:
            self._img_lab_np = self._dev_lab_net.permute(2, 0, 1).cpu().numpy()
        return self._img_lab_np

    @property
    def img_l(self):
        return self.img_lab[[0]]

    @property
    def img_ab(self):
        return self.img_lab[1:]

    @property
    def img_lab_mc(self):
        """(3, Xd, Xd) mean-centered, normalized Lab: (Lab - mean) / norm
        per channel, the net's input convention, made on first read."""
        if getattr(self, "_img_lab_mc_np", None) is None:
            norm = np.array([self.l_norm, self.ab_norm, self.ab_norm])
            mean = np.array([self.l_mean, self.ab_mean, self.ab_mean])
            self._img_lab_mc_np = (self.img_lab / norm[:, None, None]
                                   - (mean / norm)[:, None, None])
        return self._img_lab_mc_np

    @property
    def img_l_mc(self):
        return self.img_lab_mc[[0]]

    @property
    def img_ab_mc(self):
        return self.img_lab_mc[[1, 2]]

    # ``_dev_output_ab`` is a property so the host-composed abq click can
    # park its requantized ab on the host: the (Xd, Xd, 2) upload happens
    # only when a full-res getter reads the device copy
    @property
    def _dev_output_ab(self):
        val = self._dev_out_ab_val
        if val is None and self._out_ab_host_pending is not None:
            val = self._dev_out_ab_val = self._to_dev(
                self._out_ab_host_pending)
        return val

    @_dev_output_ab.setter
    def _dev_output_ab(self, value):
        self._dev_out_ab_val = value
        self._out_ab_host_pending = None

    def _set_out_ab_(self):
        # output_ab is the ab of the QUANTIZED uint8 frame's own Lab
        # (computed by the click on the device); numpy mirrors are lazy
        self._out_ab_np = None
        self._out_lab_np = None

    def _set_out_ab_host_(self, a, b):
        """The abq click's twin of ``_set_out_ab_``: the requantized ab
        planes come from the host-composed frame; the device copy is
        uploaded on first read (``_dev_output_ab``)."""
        self._out_lab_np = None
        self._out_ab_np = np.stack([a, b])
        self._dev_out_ab_val = None
        self._out_ab_host_pending = np.stack([a, b], -1)

    @property
    def output_ab(self):
        if getattr(self, "_out_ab_np", None) is None:
            self._out_ab_np = (self._dev_output_ab.permute(2, 0, 1)
                               .cpu().numpy())
        return self._out_ab_np

    @property
    def output_lab(self):
        if getattr(self, "_out_lab_np", None) is None:
            self._out_lab_np = rgb2lab_transpose(self.output_rgb,
                                                 self.device)
        return self._out_lab_np


class ColorizeImageTorch(ColorizeImageBase):
    """SIGGRAPH U-Net backend (the reference's torch backend: l_norm =
    ab_norm = 1, l_mean = 50, mask_mult = 1, optional maskcent)."""

    def __init__(self, Xd=256, maskcent=False, device=None):
        super().__init__(Xd, device=device)
        self.l_norm = 1.
        self.ab_norm = 1.
        self.l_mean = 50.
        self.ab_mean = 0.
        self.mask_mult = 1.
        self.mask_cent = .5 if maskcent else 0
        self.pts_in_hull = make_pts_grid()               # 529x2 full grid

    def prep_net(self, gpu_id=None, path='', dist=False, dtype=None,
                 width=1.0):
        """Load the weights at ``path`` (``.npz`` in the JAX package's HWIO
        layout or in torch's, or a ``.pth`` state dict); without a path,
        seeded random weights at ``width``. ``gpu_id`` is accepted for the
        reference's signature; the device was chosen at construction. With
        ``dist=True`` ``net_forward`` runs the distribution head and the
        model has no click programs.

        ``dtype``: optional serving precision of the weights, cast after
        loading (``"bfloat16"``: the convs run in bf16 on the tensor cores
        with f32 accumulation, see ``SIGGRAPHGenerator.cast_weights_``).
        None keeps f32, the parity mode."""
        sd = load_state_dict_file(path) if path else init_state_dict(width)
        self.net = SIGGRAPHGenerator.from_state_dict(sd).to(
            self.device).requires_grad_(False).cast_weights_(dtype)
        self.dist = dist
        dev = self.device
        if not dist:
            mc = self.mask_cent

            def fwd(A, B, M):
                # torch conventions: ab_mean=0, ab_norm=1, mask_mult=1 ->
                # the raw table values feed the net directly
                return self.net(A, B, M, mc)

            self._fwd_tbl = fwd
            self._click = P.make_click_program(fwd, dev)
            self._click_tbl = P.make_table_click_program(fwd, self.Xd, dev)
            self._click_tbl_win = P.make_table_click_win_program(
                fwd, self.Xd, dev)
            self._click_tbl_win_suggest = \
                P.make_table_click_win_suggest_program(fwd, self.Xd, dev)
            self._click_tbl_suggest = P.make_table_click_suggest_program(
                fwd, self.Xd, dev)
            self._click_tbl_abq = P.make_table_click_abq_program(
                fwd, self.Xd, device=dev)
            self._click_tbl_abq_half = P.make_table_click_abq_program(
                fwd, self.Xd, half=True, device=dev)
        self.net_set = True

    def _dist_forward(self, l_mc, ab, mask):
        """l_mc (Xd,Xd,1), ab (2,Xd,Xd), mask (1,Xd,Xd) -> (reg2 (2,Xd,Xd),
        the double-110 regression; the (Xd/4, Xd/4, 529) distribution map,
        bins last so a pixel's pdf is contiguous)."""
        with torch.no_grad():
            reg2, dist_cl = self.net(l_mc.permute(2, 0, 1)[None], ab[None],
                                     mask[None], self.mask_cent, dist=True,
                                     dist_lowres=True)
        return reg2[0], dist_cl[0].permute(1, 2, 0).contiguous()

    def net_forward(self, input_ab, input_mask):
        if super().net_forward(input_ab, input_mask) == -1:
            return -1
        if self.dist:
            ab = self._to_dev(self.input_ab_mc, torch.float32)
            mask = self._to_dev(self.input_mask_mult, torch.float32)
            # The reference's dist backend returns the raw (double-110)
            # regression array and composes no frame. The map stays at
            # Xd/4 on the device (a nearest-x4 lookup is an index mapping).
            reg2, self._dev_dist = self._dist_forward(self._dev_l_mc, ab,
                                                      mask)
            return reg2.cpu().numpy()
        self._set_outputs(*self._dispatch_click())
        return self.output_rgb

    def _dispatch_click(self):
        if self.dist:
            return None
        ab = self._to_dev(self.input_ab_mc, torch.float32)
        mask = self._to_dev(self.input_mask_mult, torch.float32)
        return self._click(
            self._dev_l_net, self._dev_l_mc.permute(2, 0, 1)[None],
            ab[None], mask[None])


class ColorizeImageTorchDist(ColorizeImageTorch):
    """SIGGRAPH backend with the 529-bin distribution head and the color
    suggestions. Each model owns a ``torch.Generator`` seeded 0 on its
    device, where the JAX class owns a key."""

    dist_map_div = 4      # the device map is kept at Xd/4 (nearest-x4)

    # Bounds for the suggestion parameters a client may set: on the card
    # each distinct (K, N) is a captured graph of the whole dist forward
    # and chain (its own buffers, a warm-up and a capture), so the values
    # are validated and the program cache is bounded, FIFO, as the JAX
    # class bounds its compiled programs.
    MAX_SUGGEST_K = 25
    MAX_SUGGEST_N = 100_000
    _SUGGEST_CACHE_MAX = 8

    def __init__(self, Xd=256, maskcent=False, device=None):
        super().__init__(Xd, maskcent, device=device)
        self.dist_ab_set = False
        self.pts_grid = make_pts_grid()
        self.in_hull = np.ones(529, dtype=bool)
        self.AB = 529
        self.A = self.B = 23
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._dev_dist = None
        self._dist_np = None

    def prep_net(self, gpu_id=None, path='', dist=True, S=.2, dtype=None):
        super().prep_net(gpu_id, path, dist=True, dtype=dtype)
        self._predict_tbl = P.make_table_dist_program(
            self._dist_fwd_tbl, self.Xd, self.device)
        self._suggest_tbl_cache = {}

    def _dist_fwd_tbl(self, l_mc, ab, mask):
        return self._dist_forward(l_mc, ab, mask)[1]

    def _set_dist(self, dist_map):
        self._dev_dist = dist_map
        self.dist_ab_set = True
        self._dist_np = None          # the numpy mirrors are lazy

    def predict_dist_table(self, boxes, values, count):
        """The per-image suggestion forward from a hint table: K1
        rasterizes, the distribution map is set on the device, and nothing
        is read back (the hint mirrors are rasterized on the host). The
        regression output is discarded, as the reference's predict_color
        does."""
        if not (self.img_l_set and self.net_set):
            return -1
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        dist_map, _hints = self._predict_tbl(
            self._dev_l_mc, *self._dev_table(boxes, values, count))
        self._set_dist(self._keep(dist_map))
        return 0

    def ensure_suggest_program(self, K=9, N=25000):
        """The suggest program for a validated (K, N). Raises ValueError on
        out-of-range values (a server maps it to HTTP 400). The cache holds
        at most ``_SUGGEST_CACHE_MAX`` programs, FIFO, as the JAX class's.

        The JAX class can also compile a program ahead of its first call
        from shape structs alone (``compile_now``); a CUDA graph is captured
        from a real run on real buffers, so the port captures at the first
        call and has no such option."""
        K, N = int(K), int(N)
        if not 1 <= K <= self.MAX_SUGGEST_K:
            raise ValueError(
                f"k must be in [1, {self.MAX_SUGGEST_K}], got {K}")
        if not 1000 <= N <= self.MAX_SUGGEST_N:
            raise ValueError(
                f"N must be in [1000, {self.MAX_SUGGEST_N}], got {N}")
        prog = self._suggest_tbl_cache.get((K, N))
        if prog is None:
            while len(self._suggest_tbl_cache) >= self._SUGGEST_CACHE_MAX:
                self._suggest_tbl_cache.pop(
                    next(iter(self._suggest_tbl_cache)))
            prog = self._suggest_tbl_cache[(K, N)] = \
                P.make_table_suggest_program(
                    self._dist_fwd_tbl, self.Xd, K=K, N=N,
                    map_div=self.dist_map_div, device=self.device)
        return prog

    def suggest_table(self, boxes, values, count, h, w, K=9, N=25000):
        """Serving suggest: hint-table dist forward + CMF sampling +
        k-means + uint8 palette at pixel (h, w).

        Returns ``(colors_u8 (K,3), conf (K,))``. The distribution map
        stays on the device for later ``get_ab_reccs`` /
        ``compute_entropy``. -1 on unset image or net."""
        if not (self.img_l_set and self.net_set):
            return -1
        prog = self.ensure_suggest_program(K, N)
        if self._set_hint_mirrors(boxes, values, count) == -1:
            return -1
        dist_map, colors, conf, _hints = prog(
            self._dev_l_net, self._dev_l_mc,
            *self._dev_table(boxes, values, count, h, w),
            self._dev_pts(), self._generator)
        self._set_dist(self._keep(dist_map))
        return colors.cpu().numpy(), conf.cpu().numpy()

    def net_forward(self, input_ab, input_mask):
        out = super().net_forward(input_ab, input_mask)
        if np.isscalar(out) and out == -1:   # precondition failure only:
            return -1                        # never test the float output
        self.dist_ab_set = True
        self._dist_np = None
        return out

    @property
    def dist_ab(self):
        """(529, Xd, Xd): the reference's x4-nearest-upsampled view of the
        map, made on first read (139 MB at Xd=256)."""
        if self._dist_np is None:
            lo = self._dev_dist.permute(2, 0, 1).cpu().numpy()
            self._dist_np = lo.repeat(4, axis=1).repeat(4, axis=2)
        return self._dist_np

    @property
    def dist_ab_full(self):
        return self.dist_ab

    @property
    def dist_ab_grid(self):
        return self.dist_ab_full.reshape((self.A, self.B, self.Xd, self.Xd))

    def get_ab_reccs(self, h, w, K=5, N=25000, return_conf=False):
        if not self.dist_ab_set:
            print('Need to set prediction first')
            return 0
        # the device map is at Xd/4; nearest-x4 lookup == (h//4, w//4)
        centers, conf = P.suggest_at(self._dev_dist, int(h) // 4,
                                     int(w) // 4, self._dev_pts(),
                                     self._generator, K=K, N=N)
        centers, conf = centers.cpu().numpy(), conf.cpu().numpy()
        return (centers, conf) if return_conf else centers

    def compute_entropy(self):
        lo = P.dist_entropy(self._dev_dist).cpu().numpy()
        self.dist_entropy = lo.repeat(4, axis=0).repeat(4, axis=1)

    def plot_dist_grid(self, h, w):
        import matplotlib.pyplot as plt
        plt.figure()
        plt.imshow(self.dist_ab_grid[:, :, h, w],
                   extent=[-110, 110, 110, -110], interpolation='nearest')
        plt.colorbar()
        plt.ylabel('a')
        plt.xlabel('b')

    def plot_dist_entropy(self):
        import matplotlib.pyplot as plt
        plt.figure()
        plt.imshow(-self.dist_entropy, interpolation='nearest')
        plt.colorbar()


class ColorizeImageTorchCaffe(ColorizeImageBase):
    """Caffe main-graph backend (``mask_mult`` = 110): the dense click, the
    table click and the window click over ``CaffeColorNet('main')``."""

    variant = "main"

    def __init__(self, Xd=256, device=None):
        super().__init__(Xd, device=device)
        self.l_norm = 1.
        self.ab_norm = 1.
        self.l_mean = 50.
        self.ab_mean = 0.
        self.mask_mult = 110.
        self.pred_ab_layer = 'pred_ab'
        self.pts_in_hull = get_bins().pts_in_hull

    def prep_net(self, gpu_id=None, prototxt_path='', caffemodel_path='',
                 dtype=None):
        """``prototxt_path`` is accepted for the reference's signature and
        unused (the graph is built in), as is ``gpu_id`` (the device was
        chosen at construction). ``caffemodel_path``: a raw ``.caffemodel``
        (parsed by ``models.caffemodel_io``), converted weights as ``.npz``
        (the JAX package's layout, or torch's) or ``.pth``; without a path,
        seeded random weights. ``dtype``: optional serving precision of the
        convs (``"bfloat16"``); None keeps f32, the parity mode."""
        if caffemodel_path and caffemodel_path.endswith(".caffemodel"):
            from ..models.caffemodel_io import load_caffemodel
            sd = load_caffemodel(caffemodel_path, self.variant)
        elif caffemodel_path:
            sd = caffe_net.load_state_dict_file(caffemodel_path,
                                                self.variant)
        else:
            sd = caffe_net.init_state_dict(self.variant)
        self.net = caffe_net.CaffeColorNet.from_state_dict(
            sd, self.variant).to(self.device).requires_grad_(False) \
            .cast_weights_(dtype)
        self._make_click()
        self.net_set = True

    def _make_click(self):
        mm, dev = self.mask_mult, self.device

        def fwd(l_mc, h3):
            # h3 = (1,3,H,W) [ab_mc, mask * mask_mult]: already scaled
            return self.net.apply_main(torch.cat([l_mc, h3], 1))

        self._click = P.make_click_program(fwd, dev)

        def fwd_tbl(l_mc, ab, mask):
            # K1's planes: the mask is in {0, 1} and is scaled here
            return self.net.apply_main(torch.cat([l_mc, ab, mask * mm], 1))

        self._fwd_tbl = fwd_tbl
        self._click_tbl = P.make_table_click_program(fwd_tbl, self.Xd, dev)
        self._click_tbl_win = P.make_table_click_win_program(
            fwd_tbl, self.Xd, dev)
        self._click_tbl_suggest = P.make_table_click_suggest_program(
            fwd_tbl, self.Xd, dev)
        self._click_tbl_abq = P.make_table_click_abq_program(
            fwd_tbl, self.Xd, device=dev)
        self._click_tbl_abq_half = P.make_table_click_abq_program(
            fwd_tbl, self.Xd, half=True, device=dev)

    def _hints3(self) -> torch.Tensor:
        """(1,3,Xd,Xd) on the device: the normalized hint ab and the mask
        times ``mask_mult``, the three hint channels of the blob."""
        return self._to_dev(np.concatenate(
            [self.input_ab_mc, self.input_mask_mult], 0), torch.float32)[None]

    def _l_mc4(self) -> torch.Tensor:
        return self._dev_l_mc.permute(2, 0, 1)[None]

    def net_forward(self, input_ab, input_mask):
        if super().net_forward(input_ab, input_mask) == -1:
            return -1
        self._set_outputs(*self._dispatch_click())
        return self.output_rgb

    def _dispatch_click(self):
        return self._click(self._dev_l_net, self._l_mc4(), self._hints3())


class ColorizeImageTorchCaffeGlobDist(ColorizeImageTorchCaffe):
    """Caffe global-histogram backend: every forward takes the (313,) global
    ab histogram of a reference image (``models.global_stats.extract``), or
    -1 for none. It has the dense click only."""

    variant = "global"

    def __init__(self, Xd=256, device=None):
        super().__init__(Xd, device=device)
        self.glob_mask_mult = 1.
        self.glob_layer = 'glob_ab_313_mask'

    def _glob_array(self, glob_dist) -> np.ndarray:
        """(1, 314) histogram blob: 313 bins + the on/off mask channel;
        glob_dist=-1 means 'no histogram' and zeroes the whole blob."""
        if np.array(glob_dist).flatten()[0] == -1:
            return np.zeros((1, 314), np.float32)
        return np.concatenate(
            [np.asarray(glob_dist, np.float32).ravel(),
             [self.glob_mask_mult]]).astype(np.float32)[None]

    def _make_click(self):
        def fwd(l_mc, h3, glob):
            return self.net.apply_global(torch.cat([l_mc, h3], 1), glob)

        # the histogram is a tensor argument of the program: on the card it
        # is copied into the captured graph's own buffer at every click
        self._click = P.make_click_program(fwd, self.device)

    def _glob_click(self, glob_dist):
        return self._click(self._dev_l_net, self._l_mc4(), self._hints3(),
                           self._to_dev(self._glob_array(glob_dist)))

    def net_forward(self, input_ab, input_mask, glob_dist=-1):
        if ColorizeImageBase.net_forward(self, input_ab, input_mask) == -1:
            return -1
        self._set_outputs(*self._glob_click(glob_dist))
        return self.output_rgb

    def net_forward_fullres(self, input_ab, input_mask, glob_dist=-1):
        """Histogram-conditioned forward + full-res reconstruction with one
        readback (the full-res frame); the net-size frame stays on the
        device in ``output_rgb`` (lazy)."""
        finish = self.net_forward_fullres_async(input_ab, input_mask,
                                                glob_dist)
        return finish if finish == -1 else finish()

    def net_forward_fullres_async(self, input_ab, input_mask, glob_dist=-1):
        """The base ``net_forward_fullres_async`` with the histogram:
        dispatch and start the copy under a caller's lock, block outside."""
        if not self.img_l_set or not self.net_set:
            return -1
        if ColorizeImageBase.net_forward(self, input_ab, input_mask) == -1:
            return -1
        self._set_outputs(*self._glob_click(glob_dist))
        return self.get_img_fullres_async()

    def _dispatch_click(self):
        # the click needs the histogram argument; the base class's fused
        # forward + full-res path cannot drive it -> its sentinel -1
        return None


class ColorizeImageTorchCaffeDist(ColorizeImageTorchCaffe):
    """Caffe dist-graph backend with the 313-bin distribution at full
    resolution and the color suggestions. The map stays on the device as
    (Xd, Xd, 313), bins last (82 MB at Xd=256); ``dist_ab`` gives the
    reference's (313, Xd, Xd) on the host. Each model owns a
    ``torch.Generator`` seeded 0 on its device."""

    variant = "dist"
    dist_map_div = 1      # the device map is at full resolution

    def __init__(self, Xd=256, device=None):
        super().__init__(Xd, device=device)
        self.dist_ab_set = False
        bins = get_bins()
        self.pts_grid = bins.pts_grid
        self.in_hull = bins.in_hull
        self.AB = 529
        self.A = self.B = 23
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._dev_dist = None
        self._dist_np = None
        self._dist_full_np = None

    def prep_net(self, gpu_id=None, prototxt_path='', caffemodel_path='',
                 S=.2, dtype=None):
        super().prep_net(gpu_id, prototxt_path, caffemodel_path, dtype=dtype)
        self.S = S
        self.net.scale_S.scale.fill_(S)
        self._predict_tbl = P.make_table_dist_program(
            self._dist_fwd_tbl, self.Xd, self.device)
        self._suggest_tbl_cache = {}

    def _dist_fwd_tbl(self, l_mc, ab, mask):
        """l_mc (Xd,Xd,1), K1's ab (2,Xd,Xd) and mask (1,Xd,Xd) in {0,1} ->
        the (Xd,Xd,313) map."""
        blob = torch.cat([l_mc.permute(2, 0, 1), ab,
                          mask * self.mask_mult], 0)[None]
        return self.net.dist_map(blob)[0]

    def _make_click(self):
        def fwd(l_mc, h3):
            return self.net.apply_dist(torch.cat([l_mc, h3], 1))

        self._click = P.make_dist_click_program(fwd, self.device)

    def _dispatch_click(self):
        # the dist click has three outputs; the base class's fused forward
        # + full-res path expects (rgb, ab) -> its sentinel -1
        return None

    def _set_dist(self, dist_map):
        self._dev_dist = dist_map
        self.dist_ab_set = True
        self._dist_np = None          # the numpy mirrors are lazy
        self._dist_full_np = None

    def net_forward(self, input_ab, input_mask):
        if ColorizeImageBase.net_forward(self, input_ab, input_mask) == -1:
            return -1
        rgb, out_ab, dist_S = self._click(self._dev_l_net, self._l_mc4(),
                                          self._hints3())
        self._set_outputs(rgb, out_ab)
        self._set_dist(self._keep(dist_S))
        return self.output_rgb

    # the same contracts as the SIGGRAPH dist class's; the programs are
    # generic over the dist forward and the map's resolution (dist_map_div)
    predict_dist_table = ColorizeImageTorchDist.predict_dist_table
    suggest_table = ColorizeImageTorchDist.suggest_table
    ensure_suggest_program = ColorizeImageTorchDist.ensure_suggest_program
    MAX_SUGGEST_K = ColorizeImageTorchDist.MAX_SUGGEST_K
    MAX_SUGGEST_N = ColorizeImageTorchDist.MAX_SUGGEST_N
    _SUGGEST_CACHE_MAX = ColorizeImageTorchDist._SUGGEST_CACHE_MAX
    plot_dist_grid = ColorizeImageTorchDist.plot_dist_grid
    plot_dist_entropy = ColorizeImageTorchDist.plot_dist_entropy

    @property
    def dist_ab(self):
        """(313, Xd, Xd) on the host, made on first read."""
        if self._dist_np is None:
            self._dist_np = self._dev_dist.permute(2, 0, 1).cpu().numpy()
        return self._dist_np

    @property
    def dist_ab_full(self):
        """(529, Xd, Xd): the 313 in-hull bins scattered into the full
        grid, zeros outside the hull."""
        if self._dist_full_np is None:
            self._dist_full_np = quantize.scatter_to_grid(
                torch.from_numpy(self.dist_ab), self.in_hull).reshape(
                    529, self.Xd, self.Xd).numpy()
        return self._dist_full_np

    @property
    def dist_ab_grid(self):
        return self.dist_ab_full.reshape((self.A, self.B, self.Xd, self.Xd))

    def get_ab_reccs(self, h, w, K=5, N=25000, return_conf=False):
        if not self.dist_ab_set:
            print('Need to set prediction first')
            return 0
        centers, conf = P.suggest_at(self._dev_dist, int(h), int(w),
                                     self._dev_pts(), self._generator,
                                     K=K, N=N)
        centers, conf = centers.cpu().numpy(), conf.cpu().numpy()
        return (centers, conf) if return_conf else centers

    def compute_entropy(self):
        self.dist_entropy = P.dist_entropy(self._dev_dist).cpu().numpy()


# Drop-in aliases: reference-style code instantiates these names.
ColorizeImageCaffe = ColorizeImageTorchCaffe
ColorizeImageCaffeDist = ColorizeImageTorchCaffeDist
ColorizeImageCaffeGlobDist = ColorizeImageTorchCaffeGlobDist
