"""Session checkpointing: dump and replay interactive colorization sessions,
plus model-weight save and load.

Counterpart of ``ideepcolor_tpu/utils/session.py``. A dump is the
reference's ``save_result`` format (``im_l``/``im_ab``/``im_mask`` npys and
input/result PNGs), so dumps interchange between the two packages; the PNGs
are written by the port's own codec (``utils/imageio.py``). Weights are
saved and loaded as ``.npz`` state dicts.

The orbax pair (``save_params_orbax`` / ``load_params_orbax``) is not
ported: orbax needs JAX. Export such a checkpoint to ``.npz`` with the JAX
package's ``save_params_npz``; ``models.siggraph.load_state_dict_file``
says so when handed an orbax directory.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .imageio import encode_png


def create_temp_directory(path_template: str, N: int = int(1e8)) -> str:
    """Create a fresh randomly-numbered directory from a %d template
    (ref data/colorize_image.py:10-17)."""
    cur_path = path_template % np.random.randint(0, N)
    while os.path.exists(cur_path):
        cur_path = path_template % np.random.randint(0, N)
    os.makedirs(cur_path)
    return cur_path


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_session(save_dir: str, model, im_ab0: np.ndarray,
                 im_mask0: np.ndarray, result_rgb: np.ndarray | None = None,
                 timestamp: bool = True) -> str:
    """Dump a session in the reference's format: im_l/im_ab/im_mask npys +
    input/result PNGs. Returns the directory written."""
    if timestamp:
        suffix = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
        save_dir = f"{save_dir}_{suffix}"
    os.makedirs(save_dir, exist_ok=True)
    np.save(os.path.join(save_dir, "im_l.npy"), model.img_l)
    np.save(os.path.join(save_dir, "im_ab.npy"), im_ab0)
    np.save(os.path.join(save_dir, "im_mask.npy"), im_mask0)
    _write_png(os.path.join(save_dir, "input_mask.png"),
               (np.asarray(im_mask0)[0] * 255).astype(np.uint8))
    if result_rgb is not None:
        _write_png(os.path.join(save_dir, "ours.png"), result_rgb)
    _write_png(os.path.join(save_dir, "ours_fullres.png"),
               model.get_img_fullres())
    _write_png(os.path.join(save_dir, "input_fullres.png"),
               model.get_input_img_fullres())
    _write_png(os.path.join(save_dir, "input.png"), model.get_input_img())
    _write_png(os.path.join(save_dir, "input_ab.png"), model.get_sup_img())
    return save_dir


def load_session(save_dir: str) -> dict[str, np.ndarray]:
    """Read a session dump back: {'im_l', 'im_ab', 'im_mask'}."""
    return {name: np.load(os.path.join(save_dir, f"{name}.npy"))
            for name in ("im_l", "im_ab", "im_mask")}


def replay_session(save_dir: str, model) -> np.ndarray:
    """Re-run a dumped session's hints through a prepared model (the model
    must already have the image loaded). Returns the re-colorized frame."""
    s = load_session(save_dir)
    return model.net_forward(s["im_ab"], s["im_mask"])


# ----- model weights -----

def save_params_npz(path: str, params) -> None:
    """A state dict (tensors, or anything ``np.asarray`` takes) -> ``.npz``."""
    np.savez(path, **{k: (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
                      for k, v in params.items()})


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """``.npz`` -> a state dict of CPU tensors."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}
