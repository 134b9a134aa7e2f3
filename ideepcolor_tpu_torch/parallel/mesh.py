"""Device mesh and sharding, driven by one process.

Counterpart of ``ideepcolor_tpu/parallel/mesh.py``. JAX's mesh is one
process driving every local device; so is this one. A :class:`Mesh` is a
named grid of ``torch.device``s, and the sharded programs (the ``mesh=``
batch forms of ``engine/batch.py``, ``train.step.make_sharded_train_step``,
``train.distill.make_sharded_distill_step``) loop over its positions from
one Python thread, launching each shard's work on its device; on distinct
cards the launches overlap, as CUDA queues them asynchronously.

The layouts are JAX's:

* data parallelism over the batch: the leading axis is split over the
  (dcn, data) axes, replicated over ``model`` (:func:`batch_sharding`);
* tensor parallelism on the 512-channel dilated trunk convs of
  ``model5``-``model7``, split on their out channels over ``model``
  (:func:`param_shardings`). JAX splits its HWIO weight's LAST axis; the
  port's weights are OIHW, so they are split on axis 0, as is the bias.

Every sharding here splits at most the leading axis, so a
:class:`NamedSharding` is the mesh and the axes that leading axis is split
over. A mesh may repeat one device (``make_mesh(devices=["cpu"] * 8)``, or
``["cuda:0"] * 8``): the arithmetic of the split, the gather and the
gradient sum is then that of eight devices, and every copy between
positions is the tensor itself (the counterpart of XLA's
``--xla_force_host_platform_device_count``). A mesh lies on one kind of
device: a CUDA mesh with a CPU entry raises, and so does a CUDA tensor
placed on a CPU mesh. Nothing falls back to the CPU.

Only the single-process form of :func:`make_hybrid_mesh` is here; across
processes (``torch.distributed`` with more than one rank) it raises, ROADMAP
item 14d.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import math
import weakref

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


def _device(d) -> torch.device:
    """A mesh entry: a CUDA device always carries its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named grid of devices: ``devices`` an object ndarray of
    ``torch.device``, ``axis_names`` one name per grid axis, ``shape`` the
    ordered dict of axis sizes (``jax.sharding.Mesh.shape``). Hashable: the
    sharded programs are cached per mesh."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        cells = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            cells[pos] = _device(grid[pos])
        if len(axis_names) != cells.ndim:
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{cells.ndim}-d device grid")
        kinds = sorted({d.type for d in cells.flat})
        if len(kinds) != 1:
            raise ValueError(f"a mesh lies on one kind of device, got "
                             f"{kinds}")
        self.devices = cells
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 cells.shape))
        self._key = (self.axis_names, cells.shape,
                     tuple(str(d) for d in cells.flat))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh takes by default: every visible card (``cuda:0``
    .. ``cuda:count-1``; raises without one), or ``[cpu]`` for a CPU
    caller. The command lines and the server build their meshes from this
    function, so replacing it gives them a mesh that repeats one device."""
    dev = resolve_device(device_type)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devs, shape) -> np.ndarray:
    cells = np.empty(len(devs), dtype=object)
    cells[:] = devs
    return cells.reshape(shape)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default :func:`local_devices`; a list may repeat one device).
    ``model_parallel`` must divide ``n_devices``; 1 is pure data
    parallelism."""
    devs = list(local_devices() if devices is None else devices)
    n = n_devices or len(devs)
    if n % model_parallel:
        raise ValueError(f"{model_parallel=} must divide {n=}")
    if n > len(devs):
        raise ValueError(f"a mesh of {n=} devices needs {n} devices; "
                         f"{len(devs)} are available")
    return Mesh(_grid(devs[:n], (n // model_parallel, model_parallel)),
                (DATA_AXIS, MODEL_AXIS))


def make_hybrid_mesh(dcn_parallel: int | None = None,
                     model_parallel: int = 1, devices=None) -> Mesh:
    """A (dcn, data, model) mesh: the outermost ``dcn`` axis stands for the
    hosts, and the batch is split over (dcn, data). In one process the
    device list is reshaped, ``dcn_parallel`` standing for the host count.
    Across processes (``torch.distributed`` initialized with more than one
    rank) it raises: that form is ROADMAP item 14d."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"make_hybrid_mesh across {dist.get_world_size()} processes is "
            f"ROADMAP item 14d; this mesh is driven by one process")
    devs = list(local_devices() if devices is None else devices)
    dcn, mp = dcn_parallel or 1, model_parallel
    n = len(devs)
    if n % (dcn * mp):
        raise ValueError(f"{dcn=} x {model_parallel=} must divide {n=}")
    return Mesh(_grid(devs, (dcn, n // (dcn * mp), mp)),
                (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


class NamedSharding:
    """A tensor's layout over ``mesh``: its leading axis split over the mesh
    axes ``axes`` (in that order, JAX's ``P(axes)``), replicated over the
    others; ``axes=()`` is fully replicated."""

    def __init__(self, mesh: Mesh, axes=()):
        self.mesh = mesh
        self.axes = tuple(a for a in axes if a in mesh.axis_names)
        self.parts = math.prod(mesh.shape[a] for a in self.axes)

    @property
    def spec(self) -> tuple:
        """JAX's PartitionSpec as a tuple: one entry per sharded axis."""
        return (self.axes,) if self.axes else ()

    @property
    def is_fully_replicated(self) -> bool:
        return self.parts == 1

    def chunk(self, pos) -> int:
        """Which leading-axis chunk the mesh position ``pos`` holds."""
        k = 0
        for a in self.axes:
            i = self.mesh.axis_names.index(a)
            k = k * self.mesh.devices.shape[i] + pos[i]
        return k


class ShardedTensor:
    """A tensor laid out over a mesh: ``pieces`` maps mesh positions to the
    chunk of the leading axis each holds (see ``sharding.chunk``). Placed
    inputs (:func:`put`) have a piece at every position; the outputs of the
    sharded programs one per chunk, at the model axis's first position."""

    def __init__(self, sharding: NamedSharding, shape, pieces: dict):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.pieces = pieces

    def piece(self, pos) -> torch.Tensor:
        return self.pieces[tuple(pos)]

    def _chunks(self) -> list[torch.Tensor]:
        chunks: dict = {}
        for pos, t in self.pieces.items():
            chunks.setdefault(self.sharding.chunk(pos), t)
        if len(chunks) != self.sharding.parts:
            raise ValueError(f"{len(chunks)} of {self.sharding.parts} "
                             f"chunks are placed")
        return [chunks[k] for k in range(self.sharding.parts)]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        dev = self.sharding.mesh.devices.flat[0]
        chunks = [c.to(dev) for c in self._chunks()]
        return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def numpy(self) -> np.ndarray:
        chunks = [c.cpu().numpy() for c in self._chunks()]
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def check_placement(t: torch.Tensor, mesh: Mesh) -> None:
    """A CUDA tensor never moves to a CPU mesh (host inputs do go to a CUDA
    mesh: that is their upload)."""
    if t.device.type != "cpu" and t.device.type != mesh.device_type:
        raise ValueError(f"a tensor on {t.device} cannot be placed on a "
                         f"{mesh.device_type} mesh")


def put(x, sharding: NamedSharding) -> ShardedTensor:
    """Place ``x`` (a tensor or anything ``np.asarray`` takes) on the mesh:
    ``jax.device_put(x, sharding)``. Each chunk is copied once per distinct
    device; on a device that already holds ``x`` it is a view."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))
    mesh = sharding.mesh
    check_placement(t, mesh)
    n = sharding.parts
    if n > 1 and (t.dim() == 0 or t.shape[0] % n):
        raise ValueError(f"a leading axis of {tuple(t.shape)[:1]} does not "
                         f"split into {n} equal chunks over {sharding.axes}")
    size = t.shape[0] // n if n > 1 else 0
    made: dict = {}
    pieces = {}
    for pos in np.ndindex(mesh.devices.shape):
        dev, k = mesh.devices[pos], sharding.chunk(pos)
        if (k, dev) not in made:
            made[k, dev] = (t[k * size:(k + 1) * size] if n > 1
                            else t).to(dev)
        pieces[pos] = made[k, dev]
    return ShardedTensor(sharding, t.shape, pieces)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """The leading (batch) axis over the data axis, and over the dcn axis
    too where the mesh has one."""
    return NamedSharding(mesh, (DCN_AXIS, DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# the 512-channel dilated trunk convs (the FLOP-dominant layers) and their
# biases, split on the out-channel axis: axis 0 of the OIHW weight
TP_PARAMS = frozenset(f"{blk}.{i}.{kind}" for blk in ("model5", "model6",
                                                     "model7")
                      for i in (0, 2, 4) for kind in ("weight", "bias"))


def param_shardings(params, mesh: Mesh) -> dict:
    """Per-parameter shardings: the trunk convs' out channels over the
    model axis, everything else replicated."""
    return {k: NamedSharding(mesh, (MODEL_AXIS,) if k in TP_PARAMS else ())
            for k in params}


def shard_params(params, mesh: Mesh) -> dict:
    shardings = param_shardings(params, mesh)
    return {k: put(v, shardings[k]) for k, v in params.items()}


def shard_batch(batch, mesh: Mesh) -> dict:
    s = batch_sharding(mesh)
    return {k: put(v, s) for k, v in batch.items()}


def batch_positions(mesh: Mesh) -> list[tuple]:
    """The mesh position that runs each batch chunk, in chunk order: the
    model axis's first position of each (dcn, data) position."""
    shape = tuple(1 if a == MODEL_AXIS else n
                  for a, n in mesh.shape.items())
    return list(np.ndindex(shape))


def model_positions(mesh: Mesh, pos) -> list[tuple]:
    """The positions along the model axis at ``pos``'s (dcn, data)
    position, in model order (``[pos]`` where the mesh has no model
    axis)."""
    if MODEL_AXIS not in mesh.axis_names:
        return [tuple(pos)]
    i = mesh.axis_names.index(MODEL_AXIS)
    return [tuple(pos[:i]) + (m,) + tuple(pos[i + 1:])
            for m in range(mesh.devices.shape[i])]


def device_scope(dev: torch.device):
    """Make ``dev`` the current CUDA device (the hand-written kernels launch
    on the current device); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, dict]" = \
    weakref.WeakKeyDictionary()


def _weights_key(net: nn.Module) -> tuple:
    """Where each tensor of ``net`` lives and how often it was written: a
    load, a cast or an in-place update changes it."""
    return tuple((t.data_ptr(), t._version, t.dtype)
                 for t in net.state_dict().values())


def replicate(net: nn.Module, device: torch.device) -> nn.Module:
    """``net`` on ``device`` for inference: ``net`` itself where it lies
    there already (every position of a mesh that repeats its device), else
    a copy made once and made again after the weights change."""
    here = next(net.parameters()).device
    if here == device:
        return net
    if here.type != "cpu" and device.type == "cpu":
        raise ValueError(f"weights on {here} cannot be replicated to the "
                         f"CPU")
    key = _weights_key(net)
    per_dev = _REPLICAS.setdefault(net, {})
    hit = per_dev.get(device)
    if hit is None or hit[0] != key:
        hit = per_dev[device] = (key, copy.deepcopy(net).to(device))
    return hit[1]
