"""ColorizeImageBase-compatible API over the PyTorch/CUDA engine.

Counterpart of ``ideepcolor_tpu/api/colorize.py`` (``ColorizeImageBase``
and ``ColorizeImageJax``), exported as :class:`ColorizeImageTorch`, the
reference's own name for this backend. Same public contract: numpy
channel-first arrays in, uint8 (H, W, 3) frames out, the same method names,
state fields, -1 sentinels and shape checks.

Behind it, the image state lives on ``device`` (the card unless the caller
passes ``device="cpu"``), and every frame is composed by kernel K2; the
table click rasterizes its hints with kernel K1.

Not ported yet: the dist head and suggestions, bf16 serving, the ``abq``,
``win``, ``suggest`` and ``host`` click variants, the ``*_async`` getters
and the Caffe backends.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..engine import pipeline as P
from ..models.siggraph import (SIGGRAPHGenerator, init_state_dict,
                               load_state_dict_file)
from ..ops import colorspace as cs
from ..ops.cuda import colorspace_kernel as k2
from ..ops.resize import (linear_resize_matrix_np, nearest_resize_matrix_np,
                          resize_u8_half_pixel, zoom_with_matrices)


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

    def _to_dev(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                               device=self.device)

    def _frame(self, l: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> np.ndarray:
        """(H,W) L, a, b planes on the device -> (H,W,3) uint8 numpy."""
        return k2.lab_to_rgb_u8_hwc(l, a, b).cpu().numpy()

    # ----- image prep -----
    def load_image(self, input_path: str):
        import cv2                   # file decoding only; not on the path
        im = cv2.imread(input_path, 1)
        if im is None:
            raise FileNotFoundError(input_path)
        self.load_image_array(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))

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
        mirrors (``input_ab``, ``input_mask``) are K1's own output, read
        back once. Backends without a table program return -1."""
        if not self.img_l_set or not self.net_set:
            return -1
        click = getattr(self, "_click_tbl", None)
        if click is None:
            return -1
        rgb, out_ab, hints = click(
            self._dev_l_net, self._dev_l_mc,
            self._to_dev(np.asarray(boxes, np.int32)),
            self._to_dev(np.asarray(values, np.float32)), int(count))
        hints_np = hints.cpu().numpy()
        if ColorizeImageBase.net_forward(self, hints_np[:2],
                                         hints_np[2:]) == -1:
            return -1
        self._dev_output_ab = out_ab
        self.output_rgb = rgb.cpu().numpy()
        self._set_out_ab_()
        return self.output_rgb

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

    def _fullres_from_ab(self, ab_dev: torch.Tensor) -> np.ndarray:
        return P.fullres_fuse(self._dev_l_fullres, ab_dev, self._dev_rh,
                              self._dev_rw).cpu().numpy()

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

    def _set_img_lab_mc_(self):
        self._dev_l_mc = P.center_plane(self._dev_lab_net, self.l_mean,
                                        self.l_norm)     # (Xd, Xd, 1)
        self.img_l_set = True

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

    def _set_out_ab_(self):
        # output_ab is the ab of the QUANTIZED uint8 frame's own Lab
        # (computed by the click on the device); numpy mirrors are lazy
        self._out_ab_np = None
        self._out_lab_np = None

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

    def prep_net(self, gpu_id=None, path='', width=1.0):
        """Load the weights at ``path`` (``.npz`` in the JAX package's HWIO
        layout or in torch's, or a ``.pth`` state dict); without a path,
        seeded random weights at ``width``. ``gpu_id`` is accepted for the
        reference's signature; the device was chosen at construction."""
        sd = load_state_dict_file(path) if path else init_state_dict(width)
        self.net = SIGGRAPHGenerator.from_state_dict(sd).to(
            self.device).requires_grad_(False)
        mc = self.mask_cent

        def fwd(A, B, M):
            # torch conventions: ab_mean=0, ab_norm=1, mask_mult=1 -> the
            # raw table values feed the net directly
            return self.net(A, B, M, mc)

        self._click = P.make_click_program(fwd)
        self._click_tbl = P.make_table_click_program(fwd, self.Xd)
        self.net_set = True

    def net_forward(self, input_ab, input_mask):
        if super().net_forward(input_ab, input_mask) == -1:
            return -1
        rgb, out_ab = self._click(
            self._dev_l_net, self._dev_l_mc.permute(2, 0, 1)[None],
            self._to_dev(self.input_ab_mc, torch.float32)[None],
            self._to_dev(self.input_mask_mult, torch.float32)[None])
        self._dev_output_ab = out_ab
        self.output_rgb = rgb.cpu().numpy()
        self._set_out_ab_()
        return self.output_rgb
