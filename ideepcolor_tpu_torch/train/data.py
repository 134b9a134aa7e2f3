"""Training data from an image folder: batches of (L, ab) decoded, cropped
and converted on the host, prefetched by background threads.

Counterpart of ``ideepcolor_tpu/train/data.py``. Where the JAX loader
decodes with PIL, this one decodes with the port's own codec
(``utils/imageio.decode_image``: PNG natively, other formats through OpenCV
where it is installed) and resizes with its port of PIL's BILINEAR
(``ops/resize.resize_u8_pil_bilinear``). A damaged file is skipped, as the
JAX loader skips it; a file that only a missing decoder could read raises
``UnsupportedImage`` instead of shrinking the corpus in silence. Crops and
flips come from the same ``numpy`` generator calls, so both packages cut
the same boxes for one seed.

Batches are CPU tensors, NCHW: ``{'l': (N,1,S,S) in [0, 100], 'ab':
(N,2,S,S)}`` f32.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from ..ops import host
from ..ops.resize import resize_u8_pil_bilinear
from ..utils.imageio import UnsupportedImage, decode_image

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_images(root: str) -> list[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def read_rgb(path: str) -> np.ndarray | None:
    """(H, W, 3) uint8 RGB of an image file; None for a file that is
    damaged or no image. :class:`UnsupportedImage` propagates."""
    try:
        with open(path, "rb") as f:
            return decode_image(f.read())
    except UnsupportedImage:
        raise
    except (OSError, ValueError):
        return None


def _load_one(path: str, size: int, rng: np.random.Generator,
              augment: bool) -> np.ndarray | None:
    im = read_rgb(path)
    if im is None:
        return None
    if augment:
        # random resized crop (scale 0.6-1.0) + horizontal flip
        h, w = im.shape[:2]
        s = rng.uniform(0.6, 1.0)
        cw, ch = int(w * s), int(h * s)
        x0 = rng.integers(0, w - cw + 1)
        y0 = rng.integers(0, h - ch + 1)
        im = im[y0:y0 + ch, x0:x0 + cw]
        if rng.random() < 0.5:
            im = im[:, ::-1]
    return resize_u8_pil_bilinear(im, (size, size)).astype(np.float32) / 255.0


class ImageFolderLoader:
    """Iterates batch dicts over an image folder forever.

    Decoding and the Lab conversion run in ``workers`` background threads;
    ``prefetch`` finished batches are queued ahead. A worker that meets an
    image no installed decoder reads stores the error, and the next
    ``__next__`` raises it."""

    def __init__(self, root: str, batch_size: int = 16, size: int = 256,
                 seed: int = 0, augment: bool = True, workers: int = 4,
                 prefetch: int = 4):
        self.paths = list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.batch_size = batch_size
        self.size = size
        self.augment = augment
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + i,),
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    def _worker(self, seed: int):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            idx = rng.integers(0, len(self.paths), self.batch_size)
            imgs = []
            try:
                for i in idx:
                    im = _load_one(self.paths[int(i)], self.size, rng,
                                   self.augment)
                    if im is not None:
                        imgs.append(im)
            except UnsupportedImage as e:
                self._error = e
                self._stop.set()
                return
            while len(imgs) < self.batch_size:    # pad failed decodes
                imgs.append(imgs[-1] if imgs else
                            np.zeros((self.size, self.size, 3), np.float32))
            rgb = np.stack(imgs)
            # Lab on the host by the native runtime (OpenMP over the batch)
            lab = torch.from_numpy(host.rgb2lab(rgb.reshape(-1, 3)).reshape(
                rgb.shape)).permute(0, 3, 1, 2)
            batch = {"l": lab[:, :1].contiguous(),
                     "ab": lab[:, 1:].contiguous()}
            # retry the SAME batch until consumed: rebuilding on a full
            # queue would burn host CPU decoding batches nobody reads
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    pass

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                pass

    def close(self):
        self._stop.set()
