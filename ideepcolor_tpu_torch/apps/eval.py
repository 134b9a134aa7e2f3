"""Quality evaluation on the card: PSNR against the number of revealed
ground-truth hints, and hint fidelity.

Counterpart of ``ideepcolor_tpu/apps/eval.py``. Held-out images are
colorized with k simulated hints, k swept over a curve, and the mean PSNR of
the composed uint8 RGB against the original is reported (the paper's
methodology; the reference's ``get_result_PSNR``). Per chunk of images and
per count, on the device: the hint reveal (``train/hints_sim``), the
SIGGRAPH forward at f32, the Lab -> uint8 compose, which on the card is K2's
batched entry (``ops/cuda/colorspace_kernel.lab_to_rgb_u8_batch``), and the
per-image PSNR; the host receives one vector per (chunk, count).

Each chunk draws its hint locations from a generator seeded with ``seed +
chunk_index * batch`` (:func:`chunk_normals`), so every count sees the same
locations for an image. The generator is torch's on the CPU, so a run on
the card and one on the CPU place the same hints; they differ from the JAX
app's, whose key is seeded the same way.

Images are decoded by the port's codec (PNG natively, other formats through
OpenCV where it is installed) and resized with its port of PIL's BILINEAR;
the contact sheet is written as PNG.

Run: python -m ideepcolor_tpu_torch.apps.eval DATA_DIR [--weights W]
     [--hints 0,1,2,5,10,25] [--size 256] [--batch 8] [--limit N]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..models import siggraph
from ..ops import colorspace
from ..ops.cuda import colorspace_kernel as k2
from ..ops.resize import resize_u8_pil_bilinear
from ..train import hints_sim
from ..train.data import list_images
from ..utils.imageio import decode_image, encode_png
from ..utils.visualize import grid_vis


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data_dir")
    ap.add_argument("--weights", type=str, default="",
                    help="checkpoint (.npz/.pth); random init if empty "
                         "(harness smoke)")
    ap.add_argument("--hints", type=str, default="0,1,2,5,10,25",
                    help="comma-separated hint counts (<= 32)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0,
                    help="evaluate at most N images (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maskcent", type=float, default=0.0)
    ap.add_argument("--half", type=int, default=2,
                    help="hint patch half-width (patch = (2*half+1)^2)")
    ap.add_argument("--out", type=str, default="",
                    help="also write the curve as JSON")
    ap.add_argument("--fidelity", action="store_true",
                    help="also report hint-fidelity metrics (adherence "
                         "ΔE incl. counterfactual colors, influence "
                         "radius)")
    ap.add_argument("--save-grid", type=str, default="",
                    help="write a contact sheet PNG: one row per eval "
                         "image, one column per hint count (+ ground "
                         "truth)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    return ap.parse_args(argv)


def load_eval_images(root, size: int, limit: int = 0) -> np.ndarray:
    """The eval set at once: (N, size, size, 3) f32 in [0, 1]."""
    out = list(iter_image_chunks(root, size, batch=1, limit=limit))
    return (np.concatenate(out) if out
            else np.zeros((0, size, size, 3), np.float32))


def iter_image_chunks(root, size: int, batch: int, limit: int = 0):
    """Yield (n, size, size, 3) f32 chunks, n <= batch, decoding lazily.
    ``root``: a directory or a list of paths. A file that does not decode
    raises, as the JAX app's PIL decode does."""
    paths = list_images(root) if isinstance(root, str) else list(root)
    if limit:
        paths = paths[:limit]
    chunk = []
    for p in paths:
        with open(p, "rb") as f:
            im = decode_image(f.read())
        chunk.append(resize_u8_pil_bilinear(im, (size, size))
                     .astype(np.float32) / 255.0)
        if len(chunk) == batch:
            yield np.stack(chunk)
            chunk = []
    if chunk:
        yield np.stack(chunk)


def chunk_normals(key_seed: int, n: int, device) -> torch.Tensor:
    """The (n, MAX_POINTS, 2) hint-location normals of one chunk, drawn on
    the CPU from a generator seeded with ``key_seed``, on ``device``."""
    gen = torch.Generator().manual_seed(key_seed)
    return hints_sim.draw_normals(n, gen, "cpu").to(device)


def _hinted_forward_u8(maskcent: float, half: int):
    """(net, rgb01 (N,S,S,3), normals, count) -> (N,S,S,3) uint8 frames.

    The one hint reveal + forward + uint8 render behind both the PSNR step
    and the contact sheet, so the sheet shows what the curve measured."""

    def fwd(net, rgb, normals, count):
        lab = colorspace.rgb_to_lab(rgb).permute(0, 3, 1, 2)
        l, gt_ab = lab[:, :1], lab[:, 1:]
        hint_ab, hint_mask = hints_sim.reveal_fixed_from_normals(
            gt_ab, normals, count, half)
        pred_ab = net(l - 50.0, hint_ab, hint_mask, maskcent)
        return k2.lab_to_rgb_u8_batch(l[:, 0], pred_ab[:, 0], pred_ab[:, 1])

    return fwd


def make_eval_step(maskcent: float, half: int):
    """(net, rgb01 (N,S,S,3), normals, count) -> per-image PSNR (N,)."""
    fwd = _hinted_forward_u8(maskcent, half)

    def step(net, rgb, normals, count):
        pred = fwd(net, rgb, normals, count).to(torch.float32)
        gt = torch.round(rgb.clamp(0, 1) * 255.0)
        mse = ((pred - gt) ** 2).mean((1, 2, 3))
        return 20.0 * torch.log10(255.0 / torch.sqrt(mse.clamp_min(1e-12)))

    return step


def _chunks(images, batch: int):
    if isinstance(images, np.ndarray):
        return (images[i:i + batch] for i in range(0, len(images), batch))
    return images


def _padded(chunk, batch: int, device) -> tuple[torch.Tensor, int]:
    chunk = np.asarray(chunk, np.float32)
    n = len(chunk)
    if n < batch:              # the tail chunk, padded to the batch
        chunk = np.concatenate(
            [chunk, np.zeros((batch - n, *chunk.shape[1:]), np.float32)])
    return torch.from_numpy(chunk).to(device), n


@torch.no_grad()
def evaluate(net, images, counts, batch=8, seed=0, maskcent=0.0, half=2,
             return_per_image=False, device=None):
    """-> {count: mean PSNR} over all images (the padded tail dropped).

    ``net``: a SIGGRAPHGenerator or its state dict. ``images``: an
    (N,S,S,3) array in [0, 1], or an iterable of (n,S,S,3) chunks. Chunks
    loop outer and counts inner, so each image decodes once and every count
    sees the same hint locations. ``return_per_image=True`` also returns
    {count: per-image PSNRs in stream order}. ``device``: the card unless
    "cpu"."""
    counts = list(dict.fromkeys(int(k) for k in counts))
    for k in counts:
        if not 0 <= k <= hints_sim.MAX_POINTS:
            raise ValueError(
                f"hint count {k} outside [0, {hints_sim.MAX_POINTS}]")
    dev = resolve_device(device)
    net = siggraph.as_module(net, dev)
    step = make_eval_step(maskcent, half)
    per = {k: [] for k in counts}
    seen = 0
    for ci, chunk in enumerate(_chunks(images, batch)):
        x, n = _padded(chunk, batch, dev)
        normals = chunk_normals(seed + ci * batch, batch, dev)
        psnr = torch.stack([step(net, x, normals, k) for k in counts])
        for k, v in zip(counts, psnr[:, :n].cpu().numpy()):
            per[k].append(v)
        seen += n
    curve = {k: (float(np.concatenate(v).mean()) if seen else float("nan"))
             for k, v in per.items()}
    if return_per_image:
        return curve, {k: (np.concatenate(v) if seen
                           else np.zeros((0,), np.float32))
                       for k, v in per.items()}
    return curve


@torch.no_grad()
def save_colorization_grid(net, images, counts, path, maskcent=0.0, half=2,
                           seed=0, batch=8, device=None):
    """Contact sheet as PNG: a row per image, a column per hint count and
    the ground truth last, rendered in ``batch``-image chunks with
    :func:`evaluate`'s hint locations."""
    if not str(path).lower().endswith(".png"):
        raise ValueError(f"the contact sheet is written as PNG: {path} "
                         f"does not end in .png")
    dev = resolve_device(device)
    net = siggraph.as_module(net, dev)
    fwd = _hinted_forward_u8(maskcent, half)
    images = np.asarray(images, np.float32)
    cols = []
    for k in counts:
        outs = []
        for ci, i in enumerate(range(0, len(images), batch)):
            x, n = _padded(images[i:i + batch], batch, dev)
            normals = chunk_normals(seed + ci * batch, batch, dev)
            outs.append(fwd(net, x, normals, int(k))[:n].cpu().numpy())
        cols.append(np.concatenate(outs))
    cols.append(np.round(np.clip(images, 0, 1) * 255).astype(np.uint8))
    tiles = np.stack([col[i] for i in range(len(images)) for col in cols])
    canvas = grid_vis(tiles, len(images), len(cols))
    with open(path, "wb") as f:
        f.write(encode_png(canvas.astype(np.uint8)))
    return path


# ---- hint fidelity: whether the output adopts a clicked color locally, and
# how far one click reaches; checkable on any image set ----

_FIDELITY_BINS = 128        # 2-px-wide distance bins -> profile to 256 px


def _snap_plane(l: torch.Tensor, ab: torch.Tensor, iters: int = 5
                ) -> torch.Tensor:
    """Fixed-iteration gamut projection of an ab plane at lightness l (the
    GUI's snap_ab loop for a whole plane): (N,1,H,W), (N,2,H,W)."""
    lab = torch.cat([l, ab], 1).permute(0, 2, 3, 1)
    l_last = l[:, 0]
    for _ in range(iters):
        lab = torch.cat([l_last[..., None], lab[..., 1:]], -1)
        lab = colorspace.rgb_to_lab(colorspace.lab_to_rgb(lab))
    return lab[..., 1:].permute(0, 3, 1, 2)


def make_fidelity_step(maskcent: float, half: int):
    """(net, rgb01 (N,S,S,3), normals, count, rot_deg) -> (adhere, adhere0,
    mass, area) per image:

    - adhere: mean ab-plane ΔE between the hint target and the output over
      the hint pixels; the target is the ground-truth patch-mean ab rotated
      by ``rot_deg`` (chroma floored at 25 when rotated) and projected into
      the sRGB gamut at the image's L (rot 0: the true color; rot 180: a
      counterfactual one the prior argues against);
    - adhere0: the same ΔE for the zero-hint output at the same pixels;
    - mass / area: the first hint's influence profile, sum and pixel count
      of |Δab| (with the hints against without) in 2-px distance bins
      around it (meaningful at count 1)."""

    def step(net, rgb, normals, count, rot_deg):
        lab = colorspace.rgb_to_lab(rgb).permute(0, 3, 1, 2)
        l, gt_ab = lab[:, :1], lab[:, 1:]
        n, _, h, w = gt_ab.shape
        dev = rgb.device
        loc = hints_sim.locations_from_normals(normals, h, w)
        halves = torch.full((n, hints_sim.MAX_POINTS), half,
                            dtype=torch.int64, device=dev)
        alive = (torch.arange(hints_sim.MAX_POINTS, device=dev)[None]
                 < count).expand(n, hints_sim.MAX_POINTS)
        hint_ab, hint_mask = hints_sim.reveal_batch(gt_ab, loc, halves,
                                                    alive)
        th = torch.deg2rad(torch.tensor(rot_deg, dtype=torch.float32,
                                        device=dev))
        a, b = hint_ab[:, 0], hint_ab[:, 1]
        rot = torch.stack([a * torch.cos(th) - b * torch.sin(th),
                           a * torch.sin(th) + b * torch.cos(th)], 1)
        if rot_deg != 0.0:
            # a rotated near-gray hint would be vacuous: floor the chroma
            chroma = torch.linalg.vector_norm(rot, dim=1, keepdim=True)
            rot = rot * (chroma.clamp_min(25.0) / chroma.clamp_min(1e-6))
        target = _snap_plane(l, rot) * hint_mask
        A = l - 50.0
        pred = net(A, target, hint_mask, maskcent)
        pred0 = net(A, torch.zeros_like(target), torch.zeros_like(hint_mask),
                    maskcent)
        m = hint_mask[:, 0]
        npix = m.sum((1, 2)).clamp_min(1.0)
        norm = lambda t: torch.linalg.vector_norm(t, dim=1)  # noqa: E731
        adhere = (norm(pred - target) * m).sum((1, 2)) / npix
        adhere0 = (norm(pred0 - target) * m).sum((1, 2)) / npix
        diff = norm(pred - pred0)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        cy = loc[:, 0, 0].to(torch.float32)[:, None, None]
        cx = loc[:, 0, 1].to(torch.float32)[:, None, None]
        r = torch.sqrt((ys[None] - cy) ** 2 + (xs[None] - cx) ** 2)
        bins = (r / 2.0).to(torch.int64).clamp(0, _FIDELITY_BINS - 1)
        flat = (bins + torch.arange(n, device=dev)[:, None, None]
                * _FIDELITY_BINS).reshape(-1)
        mass = torch.zeros(n * _FIDELITY_BINS, device=dev).index_add_(
            0, flat, diff.reshape(-1)).view(n, _FIDELITY_BINS)
        area = torch.zeros(n * _FIDELITY_BINS, device=dev).index_add_(
            0, flat, torch.ones_like(diff).reshape(-1)).view(
                n, _FIDELITY_BINS)
        return adhere, adhere0, mass, area

    return step


def _mass_radius(mass, frac: float) -> float:
    """Radius (px) holding ``frac`` of the total influence mass, from the
    summed 2-px-bin profile (linear inside the crossing bin)."""
    c = np.cumsum(mass)
    total = c[-1]
    if total <= 0:
        return 0.0
    tgt = frac * total
    i = int(np.searchsorted(c, tgt))
    prev = c[i - 1] if i else 0.0
    within = (tgt - prev) / max(mass[i], 1e-9)
    return float((i + within) * 2.0)


@torch.no_grad()
def hint_fidelity(net, images, batch: int = 8, seed: int = 0,
                  maskcent: float = 0.0, half: int = 2,
                  counts=(1, 5, 25), rotations=(0.0, 180.0),
                  device=None) -> dict:
    """-> flat metrics: ``deltaE_h{k}_rot{r}`` (mean adherence ΔE for k
    hints at ab rotation r), ``deltaE_h{k}_rot{r}_nohint`` (the zero-hint
    baseline at the same pixels and targets), ``radius_r50_px`` /
    ``radius_r90_px`` (radius holding 50% / 90% of one true hint's
    influence). ``images`` as in :func:`evaluate`."""
    counts = list(dict.fromkeys(int(k) for k in counts))
    rotations = list(dict.fromkeys(float(r) for r in rotations))
    dev = resolve_device(device)
    net = siggraph.as_module(net, dev)
    step = make_fidelity_step(maskcent, half)
    sums = {(k, r): [0.0, 0.0] for k in counts for r in rotations}
    mass_total = np.zeros(_FIDELITY_BINS)
    seen = 0
    for ci, chunk in enumerate(_chunks(images, batch)):
        x, n = _padded(chunk, batch, dev)
        normals = chunk_normals(seed + ci * batch, batch, dev)
        for k in counts:
            for r in rotations:
                adhere, adhere0, mass, _ = step(net, x, normals, k, r)
                sums[(k, r)][0] += float(adhere[:n].sum())
                sums[(k, r)][1] += float(adhere0[:n].sum())
                if k == 1 and r == 0.0:
                    mass_total += mass[:n].sum(0).cpu().numpy()
        seen += n
    out = {}
    for (k, r), (a, a0) in sums.items():
        tag = f"deltaE_h{k}_rot{int(r)}"
        out[tag] = round(a / max(seen, 1), 3)
        out[f"{tag}_nohint"] = round(a0 / max(seen, 1), 3)
    out["radius_r50_px"] = round(_mass_radius(mass_total, 0.5), 1)
    out["radius_r90_px"] = round(_mass_radius(mass_total, 0.9), 1)
    return out


def _trapezoid(vs: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """Trapezoid rule along axis 0 of vs over the points ks."""
    dk = np.diff(ks).reshape((-1,) + (1,) * (vs.ndim - 1))
    return ((vs[1:] + vs[:-1]) * 0.5 * dk).sum(0)


def curve_auc(curve: dict) -> float | None:
    """Area under the PSNR-vs-hint-count curve over the count range (the
    count-averaged PSNR, trapezoid rule); None for a single point."""
    ks = np.asarray(sorted(int(k) for k in curve), np.float64)
    if len(ks) < 2:
        return None
    vs = np.asarray([curve[int(k)] for k in ks], np.float64)
    return float(_trapezoid(vs, ks) / (ks[-1] - ks[0]))


def per_image_auc(per_image: dict):
    """Per-image AUCs from ``evaluate(..., return_per_image=True)``; their
    mean is :func:`curve_auc` of the mean curve."""
    ks = np.asarray(sorted(int(k) for k in per_image), np.float64)
    if len(ks) < 2:
        return None
    vs = np.stack([np.asarray(per_image[int(k)], np.float64) for k in ks])
    return _trapezoid(vs, ks) / (ks[-1] - ks[0])


def auc_spread(aucs) -> dict:
    """min / max / stderr of a per-image AUC vector."""
    a = np.asarray(aucs, np.float64)
    n = len(a)
    return {
        "n_images": int(n),
        "auc_min_db": round(float(a.min()), 2) if n else None,
        "auc_max_db": round(float(a.max()), 2) if n else None,
        "auc_stderr_db": (round(float(a.std(ddof=1) / np.sqrt(n)), 2)
                          if n > 1 else None),
    }


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    sd = (siggraph.load_state_dict_file(args.weights) if args.weights
          else siggraph.init_state_dict(1.0, 0))
    net = siggraph.as_module(sd, dev)
    paths = list_images(args.data_dir)
    if args.limit:
        paths = paths[:args.limit]
    if not paths:
        print("no images found")
        return 1
    counts = [int(c) for c in args.hints.split(",")]
    chunks = iter_image_chunks(paths, args.size, args.batch)
    curve, per_img = evaluate(net, chunks, counts, batch=args.batch,
                              seed=args.seed, maskcent=args.maskcent,
                              half=args.half, return_per_image=True,
                              device=dev)
    print(f"{len(paths)} images @ {args.size}px on {dev}"
          + (f", weights={args.weights}" if args.weights else
             " (RANDOM weights: harness smoke, not a quality claim)"))
    for k, v in curve.items():
        pv = per_img[k]
        spread = (f"   [{pv.min():5.2f} .. {pv.max():5.2f}]"
                  if len(pv) else "")
        print(f"hints={k:3d}  psnr={v:6.2f} dB{spread}")
    auc = curve_auc(curve)
    spread = None
    if auc is not None:
        spread = auc_spread(per_image_auc(per_img))
        se = spread["auc_stderr_db"]
        print(f"AUC (mean PSNR over hint counts, trapezoid): {auc:.2f} dB"
              + (f" ± {se:.2f} (stderr, n={spread['n_images']}; "
                 f"min {spread['auc_min_db']:.2f}, "
                 f"max {spread['auc_max_db']:.2f})"
                 if se is not None else ""))
    fid = None
    if args.fidelity:
        images = load_eval_images(paths, args.size)
        fid = hint_fidelity(net, images, batch=args.batch, seed=args.seed,
                            maskcent=args.maskcent, half=args.half,
                            device=dev)
        for k, v in fid.items():
            print(f"fidelity {k} = {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"size": args.size, "n_images": len(paths),
                       "weights": args.weights, "psnr_by_hints": curve,
                       "auc_db": auc, "auc_spread": spread,
                       "psnr_per_image_by_hints":
                           {k: [round(float(x), 2) for x in v]
                            for k, v in per_img.items()},
                       "fidelity": fid}, f)
        print(f"wrote {args.out}")
    if args.save_grid:
        images = load_eval_images(paths, args.size)
        save_colorization_grid(net, images, counts, args.save_grid,
                               maskcent=args.maskcent, half=args.half,
                               seed=args.seed, batch=args.batch, device=dev)
        print(f"wrote {args.save_grid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
