"""Batched engines: full-res fusion throughput and batch colorization.

Counterpart of the single-device forms of ``ideepcolor_tpu/engine/batch.py``:
the batched full-res fusion, the batched hint-conditioned forwards (dense
planes or per-image hint tables), the multi-frame streaming window, the
batched suggestions and the batched global-histogram forward of the Caffe
family. They keep the JAX package's channel-last layouts at their boundary
and run the U-Net at ``precision_name="default"`` (TF32 on the card), as the
JAX functions run at ``Precision.DEFAULT``; the global-histogram form runs
at "highest", as the JAX function does. They take the module or a state dict
(``models.siggraph.as_module``, ``models.caffe_net.as_module``) where the
JAX functions take ``params``.

The batched rasterize (``jax.vmap(rasterize_hints)`` there) is kernel K1's
batched entry, one launch for N tables; the batched compose is kernel K2's,
one launch for N frames.

``mesh=`` (a ``parallel.mesh.Mesh``) shards the five public forms over the
mesh's batch axes (dcn x data), as the JAX forms do: the batch is padded to
a multiple of :func:`mesh_batch_align` with row-0 replicas, split, and each
chunk runs the single-device program above on its device (K1's batched
entry, one forward, K2's batched entry) with the weights replicated there
(``parallel.mesh.replicate``: the module itself where the device repeats).
The frames are gathered to the caller as numpy and the padding dropped. A
``device=`` that names another device than the mesh's raises, and so does a
mesh across processes, before any work: another rank's chunks cannot come
back to this host (the JAX forms fail at ``np.asarray`` there).
:func:`make_sharded_batch_forward` and :func:`make_sharded_table_forward`
run this rank's chunks of such a mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models import caffe_net
from ..models.siggraph import as_module
from ..ops import colorspace as cs
from ..ops import kmeans as km
from ..ops.cuda import colorspace_kernel as k2
from ..ops.cuda import hints_kernel as k1
from ..ops.quantize import make_pts_grid
from ..ops.resize import linear_resize_matrix_np
from ..parallel import mesh as pmesh
from . import pipeline as P


@torch.no_grad()
def batch_fullres_fuse(l_full: torch.Tensor, ab_small: torch.Tensor,
                       out_hw: tuple[int, int]) -> torch.Tensor:
    """(N,H,W,1) full-res L + (N,h,w,2) predicted ab -> (N,H,W,3) uint8.

    The batched form of the reference's get_img_fullres chain. The batch
    loops over its images, as the JAX function maps over them: each image is
    an independent matmul resize + K2 compose, and the loop keeps the live
    intermediate one image wide (a 32 x 2048^2 batched product would hold
    over 1 GB of f32 intermediates for no gain).
    """
    H, W = out_hw
    dev = l_full.device
    rh = torch.as_tensor(linear_resize_matrix_np(ab_small.shape[1], H),
                         device=dev)
    rw = torch.as_tensor(linear_resize_matrix_np(ab_small.shape[2], W),
                         device=dev)
    out = torch.empty((l_full.shape[0], H, W, 3), dtype=torch.uint8,
                      device=dev)
    for i in range(l_full.shape[0]):
        out[i] = P.fullres_fuse(l_full[i], ab_small[i], rh, rw)
    return out


def _forward_compose(net, l_raw, hint_ab, hint_mask, maskcent):
    """l_raw (N,1,S,S) L in [0,100], hint_ab (N,2,S,S), hint_mask (N,1,S,S)
    -> (uint8 frames (N,S,S,3), predicted ab (N,2,S,S))."""
    ab = net(l_raw - 50.0, hint_ab, hint_mask, maskcent,
             precision_name="default")
    return k2.lab_to_rgb_u8_batch(l_raw[:, 0], ab[:, 0], ab[:, 1]), ab


@torch.no_grad()
def batch_forward_frames(weights, l_mc: torch.Tensor, hint_ab: torch.Tensor,
                         hint_mask: torch.Tensor, maskcent: float = 0.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched hint-conditioned colorization: (N,Xd,Xd,*) channel-last
    inputs (mean-centered L, hint ab, hint mask) -> (uint8 frames
    (N,Xd,Xd,3), predicted ab (N,Xd,Xd,2))."""
    net = as_module(weights, l_mc.device)
    rgb, ab = _forward_compose(net, l_mc.permute(0, 3, 1, 2) + 50.0,
                               hint_ab.permute(0, 3, 1, 2),
                               hint_mask.permute(0, 3, 1, 2), maskcent)
    return rgb, ab.permute(0, 2, 3, 1)


@torch.no_grad()
def batch_forward_frames_table(weights, l_mc: torch.Tensor,
                               boxes: torch.Tensor, values: torch.Tensor,
                               counts: torch.Tensor, maskcent: float = 0.0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched colorization fed by per-image hint TABLES: (N,M,4) int32
    boxes + (N,M,2) values + (N,) int32 live counts, on ``l_mc``'s device,
    instead of dense planes. K1's batched entry rasterizes all N tables in
    one launch: the batched form of the table click."""
    net = as_module(weights, l_mc.device)
    hints = k1.rasterize_hints_batch(boxes, values, counts, l_mc.shape[1])
    rgb, ab = _forward_compose(net, l_mc.permute(0, 3, 1, 2) + 50.0,
                               hints[:, :2], hints[:, 2:], maskcent)
    return rgb, ab.permute(0, 2, 3, 1)


def frame_delta_stats(a, b):
    """(max |delta| in uint8 LSBs, fraction of exactly-equal pixels)
    between two uint8 frame stacks: the audit two runs of one batch are
    held to where their convs may differ in the last float bits (another
    batch size, another precision mode), which can flip isolated uint8
    values by 1."""
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    return int(d.max()), float((d == 0).all(axis=-1).mean())


def _prep_l_mc(x: torch.Tensor) -> torch.Tensor:
    """(N,S,S,3) float RGB in [0,1] -> mean-centered L (N,S,S,1)."""
    return cs.rgb_to_lab(x)[..., :1] - 50.0


def _images(images_rgb, dev) -> torch.Tensor:
    imgs = torch.as_tensor(np.ascontiguousarray(images_rgb), device=dev)
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) / 255.0
    return imgs.to(torch.float32)


def mesh_batch_align(mesh) -> int:
    """Batch-axis alignment of a mesh: the product of every axis the
    leading (batch) dimension is split over (dcn x data)."""
    return (mesh.shape.get(pmesh.DCN_AXIS, 1)
            * mesh.shape.get(pmesh.DATA_AXIS, 1))


def _pad_batch(n: int, align: int, *arrays):
    """Pad each array's leading axis from n up to the next multiple of
    ``align`` by repeating its row 0 (padded rows are dropped by the
    caller, so their content only has to be valid: a copy of row 0 is
    always a legal table). Returns (n_padded, tensors)."""
    pad = (-n) % align
    if pad == 0:
        return n, arrays
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        out.append(torch.cat([a, a[:1].expand(pad, *a.shape[1:])]))
    return n + pad, tuple(out)


def _device_for(mesh, device) -> torch.device:
    """Where a call prepares its inputs: ``device`` (the card unless
    "cpu"), or the mesh's first device, which ``device`` must then name
    too. A mesh across processes raises."""
    if mesh is None:
        return resolve_device(device)
    if mesh.spans_processes:
        # JAX's forms fail here too, later: np.asarray of an array whose
        # shards live in another process
        others = sorted({int(r) for r in mesh.ranks.flat} - {mesh.rank})
        raise ValueError(
            f"the mesh= batch forms bring their frames back to this host "
            f"whole, but this mesh's chunks on rank(s) {others} are not "
            f"addressable from rank {mesh.rank}; give the batch forms a "
            f"mesh of this process's devices")
    first = mesh.devices.flat[0]
    if device is not None:
        d = torch.device(device)
        if d.type != first.type or (d.index is not None and d != first):
            raise ValueError(f"device={d} disagrees with the mesh, whose "
                             f"devices are {mesh.device_type} from {first}")
    return resolve_device(first)


def _sharded(body, mesh, n_batch: int, build, index0: bool = False):
    """``body(net, *chunk args, *rest, **kw)`` as a program over ``mesh``:
    the first ``n_batch`` arguments are ShardedTensors placed with the
    batch sharding, and each chunk runs on its device with ``net``
    replicated there (``index0``: the chunk's first global row is passed
    as ``index0=``). ``build(weights, device)`` makes the module from a
    state dict. Returns (fn, batch sharding); fn's outputs are
    ShardedTensors with one piece per chunk of this rank."""
    batch_s = pmesh.batch_sharding(mesh)
    positions = pmesh.batch_positions(mesh)
    local = set(pmesh.local_batch_positions(mesh))

    def fn(weights, *args, **kw):
        net = (weights if isinstance(weights, nn.Module)
               else build(weights, mesh.first_local_device))
        outs = {}
        for j, pos in enumerate(positions):
            if pos not in local:
                continue
            dev = mesh.devices[pos]
            chunk = [a.piece(pos) for a in args[:n_batch]]
            rest = []
            for r in args[n_batch:]:
                if isinstance(r, torch.Tensor):
                    pmesh.check_placement(r, mesh)
                    r = r.to(dev)
                rest.append(r)
            if index0:
                kw["index0"] = j * chunk[0].shape[0]
            with pmesh.device_scope(dev):
                out = body(pmesh.replicate(net, dev), *chunk, *rest, **kw)
            outs[pos] = out if isinstance(out, tuple) else (out,)
        n = args[0].shape[0]
        first = next(iter(outs.values()))
        res = tuple(
            pmesh.ShardedTensor(batch_s, (n, *first[i].shape[1:]),
                                {pos: o[i] for pos, o in outs.items()})
            for i in range(len(first)))
        return res if len(res) > 1 else res[0]

    return fn, batch_s


def _placer(batch_s):
    def place_batch(*arrays):
        return tuple(pmesh.put(a, batch_s) for a in arrays)
    return place_batch


# one program per mesh and form, as the JAX package caches one jit each
@functools.lru_cache(maxsize=8)
def _sharded_forward_for(mesh):
    return _sharded(batch_forward_frames, mesh, 3, as_module)


@functools.lru_cache(maxsize=8)
def _sharded_table_forward_for(mesh):
    return _sharded(batch_forward_frames_table, mesh, 4, as_module)


def make_sharded_batch_forward(mesh):
    """Data-parallel dense-hint batched forward over ``mesh``: inputs split
    over its batch axes, weights replicated. Returns (fn, place_batch):
    ``fn(weights, *place_batch(l_mc, hint_ab, hint_mask), maskcent)`` ->
    (frames, ab) ShardedTensors. Cached per mesh."""
    fn, batch_s = _sharded_forward_for(mesh)
    return fn, _placer(batch_s)


def make_sharded_table_forward(mesh):
    """Data-parallel table-hint batched forward over ``mesh`` (cached per
    mesh): ``fn(weights, *place_batch(l_mc, boxes, values, counts),
    maskcent)`` -> (frames, ab) ShardedTensors."""
    fn, batch_s = _sharded_table_forward_for(mesh)
    return fn, _placer(batch_s)


def _on_mesh(sharded_for, mesh, net, batch_args, *rest, **kw):
    """Pad ``batch_args`` to the mesh's alignment, place them, run the
    cached program -> (n before padding, its outputs)."""
    n = int(batch_args[0].shape[0])
    _, batch_args = _pad_batch(n, mesh_batch_align(mesh), *batch_args)
    fn, batch_s = sharded_for(mesh)
    return n, fn(net, *_placer(batch_s)(*batch_args), *rest, **kw)


def colorize_batch_table(weights, images_rgb, boxes, values, counts,
                         maskcent: float = 0.0, mesh=None,
                         device=None) -> np.ndarray:
    """Table-hint form of :func:`colorize_batch`: uint8 RGB images +
    per-image hint tables in, colorized uint8 frames out. Runs on the card
    unless ``device="cpu"``. With ``mesh`` any n >= 1 is split over the
    mesh (padded to its alignment, the padding dropped on return)."""
    dev = _device_for(mesh, device)
    net = as_module(weights, dev)
    args = (_prep_l_mc(_images(images_rgb, dev)),
            torch.as_tensor(np.asarray(boxes, np.int32), device=dev),
            torch.as_tensor(np.asarray(values, np.float32), device=dev),
            torch.as_tensor(np.asarray(counts, np.int32), device=dev))
    if mesh is not None:
        n, (rgb, _ab) = _on_mesh(_sharded_table_forward_for, mesh, net,
                                 args, float(maskcent))
        return rgb.numpy()[:n]
    rgb, _ab = batch_forward_frames_table(net, *args, float(maskcent))
    return rgb.cpu().numpy()


def colorize_batch(weights, images_rgb, hint_ab=None, hint_mask=None,
                   maskcent: float = 0.0, mesh=None,
                   device=None) -> np.ndarray:
    """Convenience batched serving: uint8 RGB images in, colorized uint8
    frames out.

    images_rgb: (N, S, S, 3) uint8 or float [0,1]; optional dense hints
    (N, S, S, 2) / (N, S, S, 1). The grayscale L is extracted on the device;
    hints default to zero (automatic colorization). Runs on the card unless
    ``device="cpu"``; with ``mesh`` the batch is split over its batch axes.
    """
    dev = _device_for(mesh, device)
    net = as_module(weights, dev)
    imgs = _images(images_rgb, dev)
    n, s = imgs.shape[0], imgs.shape[1]
    hint_ab = (torch.zeros((n, s, s, 2), device=dev) if hint_ab is None else
               torch.as_tensor(np.asarray(hint_ab, np.float32), device=dev))
    hint_mask = (torch.zeros((n, s, s, 1), device=dev) if hint_mask is None
                 else torch.as_tensor(np.asarray(hint_mask, np.float32),
                                      device=dev))
    args = (_prep_l_mc(imgs), hint_ab, hint_mask)
    if mesh is not None:
        n, (rgb, _ab) = _on_mesh(_sharded_forward_for, mesh, net, args,
                                 float(maskcent))
        return rgb.numpy()[:n]
    rgb, _ab = batch_forward_frames(net, *args, float(maskcent))
    return rgb.cpu().numpy()


@torch.no_grad()
def batch_stream_window_u8(weights, gray_u8: torch.Tensor,
                           boxes: torch.Tensor, values: torch.Tensor, count,
                           maskcent: float = 0.0) -> torch.Tensor:
    """A WINDOW of video frames through the streaming step at once: (T, S,
    S, 1) uint8 gray frames + ONE shared hint table (the semantics of
    ``engine.streaming._stream_step_u8_table``: K1 on the device, linear
    u8 -> L dequantization) -> (T, S, S, 3) uint8 frames. One K1 launch, one
    forward over the T frames, one launch of K2's batched entry."""
    net = as_module(weights, gray_u8.device)
    t, size = gray_u8.shape[0], gray_u8.shape[1]
    hints = k1.rasterize_hints_planar(boxes, values, count, size)
    l_raw = gray_u8.permute(0, 3, 1, 2).to(torch.float32) * (100.0 / 255.0)
    return _forward_compose(net, l_raw, hints[None, :2].expand(t, -1, -1, -1),
                            hints[None, 2:].expand(t, -1, -1, -1),
                            maskcent)[0]


@functools.lru_cache(maxsize=8)
def _sharded_stream_window_for(mesh):
    return _sharded(batch_stream_window_u8, mesh, 1, as_module)


def stream_window_u8(weights, frames_u8, boxes, values, count,
                     maskcent: float = 0.0, mesh=None,
                     device=None) -> np.ndarray:
    """Public multi-frame streaming step: (T, S, S, 1) uint8 gray frames +
    one tracked-hint table in, (T, S, S, 3) uint8 colorized frames out.
    Runs on the card unless ``device="cpu"``. With ``mesh`` the frame
    window is split over its batch axes (padded with frame-0 replicas,
    dropped on return); the table is replicated, and each chunk rasterizes
    it with K1's by-value entry on its device."""
    dev = _device_for(mesh, device)
    net = as_module(weights, dev)
    frames = torch.as_tensor(np.ascontiguousarray(frames_u8, np.uint8),
                             device=dev)
    table = (torch.as_tensor(np.asarray(boxes, np.int32), device=dev),
             torch.as_tensor(np.asarray(values, np.float32), device=dev),
             int(count), float(maskcent))
    if mesh is not None:
        t, rgb = _on_mesh(_sharded_stream_window_for, mesh, net, (frames,),
                          *table)
        return rgb.numpy()[:t]
    return batch_stream_window_u8(net, frames, *table).cpu().numpy()


def image_generator(seed: int, index: int, device) -> torch.Generator:
    """The random stream of image ``index`` of a batch seeded ``seed``:
    independent per image and the same whatever the batch holds besides
    (where the JAX package folds the index into its key)."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 32) | int(state[1]))


@torch.no_grad()
def batch_suggest_table(weights, l_mc: torch.Tensor, boxes: torch.Tensor,
                        values: torch.Tensor, counts: torch.Tensor,
                        hs: torch.Tensor, ws: torch.Tensor,
                        centers_tbl: torch.Tensor, seed: int = 0,
                        maskcent: float = 0.0, K: int = 9, N: int = 25000,
                        index0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched serving suggest: per-image hint tables and click pixels ->
    K-color suggestion palettes, one forward over the whole batch.

    The batched form of ``engine.pipeline.make_table_suggest_program``:
    K1's batched entry rasterizes the B tables in one launch, ONE dist
    forward over the batch (the SIGGRAPH 529-way head at H/4, default
    precision), then per image the CMF sampling and the weighted k-means at
    its pixel, each image with a generator of its own
    (:func:`image_generator`), and one K2 launch for the (B, K) palettes at
    the pixels' own L. l_mc (B,S,S,1); boxes (B,M,4) int32, values (B,M,2),
    counts, hs, ws (B,) int32, all on ``l_mc``'s device (nothing is read
    back). Row i is image ``index0 + i`` of the whole batch, whose
    generator it takes. Returns (colors_u8 (B,K,3), conf (B,K))."""
    net = as_module(weights, l_mc.device)
    size = l_mc.shape[1]
    hints = k1.rasterize_hints_batch(boxes, values, counts, size)
    _reg, dist_map = net(l_mc.permute(0, 3, 1, 2), hints[:, :2],
                         hints[:, 2:], maskcent, dist=True, dist_lowres=True,
                         precision_name="default")
    dist_map = dist_map.permute(0, 2, 3, 1)          # (B, S/4, S/4, 529)
    labs, confs = [], []
    for i in range(l_mc.shape[0]):
        h, w = hs[i:i + 1], ws[i:i + 1]
        centers, conf = km.ab_recommendations(
            P.pixel_at(dist_map[i], h // 4, w // 4), centers_tbl,
            image_generator(seed, index0 + i, l_mc.device), K=K, N=N)
        lum = P.pixel_at(l_mc[i], h, w) + 50.0
        labs.append(torch.cat([lum.expand(K, 1), centers], 1))
        confs.append(conf)
    lab = torch.stack(labs)                          # (B, K, 3)
    return (k2.lab_to_rgb_u8_hwc(lab[..., 0], lab[..., 1], lab[..., 2]),
            torch.stack(confs))


@functools.lru_cache(maxsize=8)
def _sharded_suggest_for(mesh):
    return _sharded(batch_suggest_table, mesh, 6, as_module, index0=True)


def suggest_batch_table(weights, images_rgb, boxes, values, counts, hs, ws,
                        K: int = 9, N: int = 25000, maskcent: float = 0.0,
                        mesh=None, seed: int = 0, device=None):
    """Public batched suggest: uint8 RGB images + hint tables + click
    points in, (colors_u8 (n,K,3), conf (n,K)) numpy out. Runs on the card
    unless ``device="cpu"``. With ``mesh`` the batch is split over its
    batch axes (padded with row-0 replicas, dropped on return); each image
    keeps the generator of its global index, so the palettes are those of
    the unsharded call."""
    dev = _device_for(mesh, device)
    net = as_module(weights, dev)
    i32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int32), device=dev)
    args = (_prep_l_mc(_images(images_rgb, dev)), i32(boxes),
            torch.as_tensor(np.asarray(values, np.float32), device=dev),
            i32(counts), i32(hs), i32(ws))
    rest = (torch.as_tensor(make_pts_grid(), dtype=torch.float32,
                            device=dev), seed, float(maskcent))
    if mesh is not None:
        n, (colors, conf) = _on_mesh(_sharded_suggest_for, mesh, net, args,
                                     *rest, K=K, N=N)
        return colors.numpy()[:n], conf.numpy()[:n]
    colors, conf = batch_suggest_table(net, *args, *rest, K=K, N=N)
    return colors.cpu().numpy(), conf.cpu().numpy()


@torch.no_grad()
def batch_forward_frames_global(weights, l_mc: torch.Tensor,
                                hints3: torch.Tensor, glob: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched GLOBAL-HISTOGRAM conditioned forward of the Caffe global
    graph: (N,S,S,1) mean-centered L planes + (N,S,S,3) dense hint planes
    (ab, mask x 110) + per-image (N,314) histogram blobs (313 bins and the
    on/off flag) -> (uint8 frames (N,S,S,3), predicted ab (N,S,S,2)). K2's
    batched entry composes the N frames in one launch."""
    net = caffe_net.as_module(weights, l_mc.device, "global")
    l = l_mc.permute(0, 3, 1, 2)
    ab = net.apply_global(torch.cat([l, hints3.permute(0, 3, 1, 2)], 1), glob)
    rgb = k2.lab_to_rgb_u8_batch((l + 50.0)[:, 0], ab[:, 0], ab[:, 1])
    return rgb, ab.permute(0, 2, 3, 1)


def _global_module(weights, device):
    return caffe_net.as_module(weights, device, "global")


@functools.lru_cache(maxsize=8)
def _sharded_global_forward_for(mesh):
    return _sharded(batch_forward_frames_global, mesh, 3, _global_module)


def colorize_batch_global(weights, images_rgb, glob_dists, hints3=None,
                          mesh=None, device=None) -> np.ndarray:
    """Public batched global-histogram serving: uint8 RGB images + (N,314)
    histogram blobs (a row may be all zero: unconditioned, the glob_dist=-1
    sentinel) in, colorized uint8 frames out. Runs on the card unless
    ``device="cpu"``. With ``mesh`` the batch, histograms included, is
    split over its batch axes (padded with row-0 replicas, dropped on
    return)."""
    dev = _device_for(mesh, device)
    net = _global_module(weights, dev)
    imgs = _images(images_rgb, dev)
    n, s = imgs.shape[0], imgs.shape[1]
    hints3 = (torch.zeros((n, s, s, 3), device=dev) if hints3 is None else
              torch.as_tensor(np.asarray(hints3, np.float32), device=dev))
    glob = torch.as_tensor(np.asarray(glob_dists, np.float32), device=dev)
    args = (_prep_l_mc(imgs), hints3, glob)
    if mesh is not None:
        n, (rgb, _ab) = _on_mesh(_sharded_global_forward_for, mesh, net,
                                 args)
        return rgb.numpy()[:n]
    rgb, _ab = batch_forward_frames_global(net, *args)
    return rgb.cpu().numpy()
