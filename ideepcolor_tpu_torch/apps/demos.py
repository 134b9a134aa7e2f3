"""Headless demo sessions: the two reference notebooks as functions.

Counterpart of ``ideepcolor_tpu/apps/demos.py``: the local-hints notebook
(zero-hint colorization, then user points) and the histogram-transfer
notebook (histogram extraction + conditioned colorization) over the port's
backends. Each returns the produced images. An image argument is a path
(decoded by ``utils.imageio.read_image``: PNG natively, other formats
through OpenCV where it is installed) or an (H, W, 3) uint8 RGB array. Run
as ``python -m ideepcolor_tpu_torch.apps.demos img [out_dir]`` to write
PNGs.
"""

from __future__ import annotations

import os

import numpy as np

from .. import api
from ..models import global_stats
from ..ops.hints import put_point
from ..ops.resize import resize_u8_half_pixel
from ..utils.imageio import encode_png, read_image


def _rgb(img) -> np.ndarray:
    """A path -> its decoded RGB image; an array is returned as it is."""
    if not isinstance(img, (str, os.PathLike)):
        return np.asarray(img)
    return read_image(img)


def demo_local_hints(img, weights: str = '', Xd: int = 256,
                     backend: str = 'caffe', device=None):
    """The local-hints notebook session: zero-hint auto colorization, then
    two user points."""
    if backend == 'caffe':
        model = api.ColorizeImageTorchCaffe(Xd=Xd, device=device)
        model.prep_net(0, caffemodel_path=weights)
    else:
        model = api.ColorizeImageTorch(Xd=Xd, device=device)
        model.prep_net(path=weights)
    model.load_image_array(_rgb(img))

    results = {}
    input_ab = np.zeros((2, Xd, Xd))
    mask = np.zeros((1, Xd, Xd))
    model.net_forward(input_ab, mask)
    results['auto'] = model.get_img_fullres()
    results['gray'] = model.get_img_gray_fullres()

    # a blue point in the middle (the notebook's values, scaled to Xd)
    sc = Xd / 256.0
    put_point(input_ab, mask, [int(135 * sc), int(160 * sc)],
              max(1, int(3 * sc)), [23, -69])
    model.net_forward(input_ab, mask)
    results['hint1'] = model.get_img_fullres()
    results['hint1_input'] = model.get_input_img_fullres()
    results['hint1_mask'] = model.get_img_mask_fullres()

    # a gray point
    put_point(input_ab, mask, [int(100 * sc), int(160 * sc)],
              max(1, int(3 * sc)), [0, 0])
    model.net_forward(input_ab, mask)
    results['hint2'] = model.get_img_fullres()
    return results


def demo_global_histogram(img, ref, weights: str = '', Xd: int = 256,
                          device=None):
    """The histogram-transfer notebook session: colorize with and without a
    reference image's global ab histogram."""
    cid = api.ColorizeImageTorchCaffeGlobDist(Xd=Xd, device=device)
    cid.prep_net(0, caffemodel_path=weights)
    cid.load_image_array(_rgb(img))

    input_ab = np.zeros((2, Xd, Xd))
    input_mask = np.zeros((1, Xd, Xd))

    cid.net_forward(input_ab, input_mask)
    auto = cid.get_img_fullres()

    ref_rs = resize_u8_half_pixel(cid._to_dev(_rgb(ref)), (Xd, Xd))
    glob_dist = global_stats.extract(
        ref_rs.float() / 255.0)["glob_ab_313"].cpu().numpy()

    cid.net_forward(input_ab, input_mask, glob_dist)
    withref = cid.get_img_fullres()
    return {"auto": auto, "with_ref": withref, "glob_dist": glob_dist,
            "gray": cid.get_img_gray_fullres()}


def main(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m ideepcolor_tpu_torch.apps.demos img [out_dir]")
        return 2
    out = argv[1] if len(argv) > 1 else './demo_out'
    os.makedirs(out, exist_ok=True)
    res = demo_local_hints(argv[0])
    for k, v in res.items():
        with open(os.path.join(out, f'local_{k}.png'), 'wb') as f:
            f.write(encode_png(v))
    print(f'wrote {len(res)} local-hints results to {out}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
