"""Device mesh and sharding, one process per host.

Counterpart of ``ideepcolor_tpu/parallel/mesh.py``. JAX runs one controller
per host, each driving its local devices; so does this module, with
``torch.distributed`` for the hosts. A :class:`Mesh` is a named grid of
``torch.device``s with the rank that drives each position (a JAX device's
``process_index``). The sharded programs (the ``mesh=`` batch forms of
``engine/batch.py``, ``train.step.make_sharded_train_step``,
``train.distill.make_sharded_distill_step``) loop over this process's
positions (:meth:`Mesh.local_positions`) from one Python thread, launching
each shard's work on its device; on distinct cards the launches overlap, as
CUDA queues them asynchronously.

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

Across processes (an initialized ``torch.distributed`` group of W > 1
ranks), :func:`make_mesh` and :func:`make_hybrid_mesh` exchange each rank's
devices (``all_gather_object``) and lay them out rank-major, as JAX lays
out ``jax.devices()``; rank r drives its own positions, tensor parallelism
never crosses a process, and :func:`put` places only this rank's pieces.
With one rank, or no group, every mesh is this process's alone.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import math
import os
import weakref

import numpy as np
import torch
import torch.distributed as dist
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


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group; 0 without
    one."""
    return dist.get_rank() if _group() else 0


def process_count() -> int:
    """The ranks of the ``torch.distributed`` group; 1 without one."""
    return dist.get_world_size() if _group() else 1


def world_size() -> int:
    """The processes of this run: the group's ranks where one is
    initialized, else the launcher's ``WORLD_SIZE`` (``torchrun`` sets
    it), else 1."""
    return process_count() if _group() else int(
        os.environ.get("WORLD_SIZE", "1"))


def barrier() -> None:
    """Wait for every rank of the group; nothing with one rank."""
    if process_count() > 1:
        dist.barrier()


class Mesh:
    """A named grid of devices: ``devices`` an object ndarray of
    ``torch.device``, ``axis_names`` one name per grid axis, ``shape`` the
    ordered dict of axis sizes (``jax.sharding.Mesh.shape``), ``ranks`` the
    rank that drives each position (default: this process, at every
    position) and ``rank`` this process's. Hashable, ranks included: the
    sharded programs are cached per mesh."""

    def __init__(self, devices, axis_names, ranks=None):
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
        self.rank = process_rank()
        if ranks is None:
            ranks = np.full(cells.shape, self.rank, dtype=np.int64)
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.shape != cells.shape:
            raise ValueError(f"ranks of shape {ranks.shape} for a device "
                             f"grid of shape {cells.shape}")
        self.devices = cells
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 cells.shape))
        self._local = tuple(p for p in np.ndindex(cells.shape)
                            if ranks[p] == self.rank)
        self._key = (self.axis_names, cells.shape,
                     tuple(str(d) for d in cells.flat),
                     tuple(int(r) for r in ranks.flat))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def local_positions(self) -> list[tuple]:
        """The positions this rank drives, in grid order."""
        return list(self._local)

    @property
    def spans_processes(self) -> bool:
        """Whether another rank drives some of the positions."""
        return len(self._local) != self.ranks.size

    @property
    def first_local_device(self) -> torch.device:
        """The device of this rank's first position: where a sharded
        program keeps what it does not split (with one rank, the mesh's
        first device)."""
        if not self._local:
            raise ValueError(f"rank {self.rank} drives no position of this "
                             f"mesh")
        return self.devices[self._local[0]]

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh takes by default: this process's cards, or
    ``[cpu]`` for a CPU caller (raises without a card). One process on a
    host takes every visible card; under a launcher that starts
    ``LOCAL_WORLD_SIZE`` processes on the host, the one of ``LOCAL_RANK``
    l takes its equal share, from ``cuda:l*share``. The command lines and
    the server build their meshes from this function, so replacing it
    gives them a mesh that repeats one device."""
    dev = resolve_device(device_type)
    if dev.type == "cpu":
        return [dev]
    count = torch.cuda.device_count()
    procs = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    share = count // procs
    if share == 0:
        raise ValueError(f"{procs} processes on this host share "
                         f"{count} cards")
    first = int(os.environ.get("LOCAL_RANK", "0")) * share
    return [torch.device("cuda", i) for i in range(first, first + share)]


def _grid(devs, shape) -> np.ndarray:
    cells = np.empty(len(devs), dtype=object)
    cells[:] = devs
    return cells.reshape(shape)


def _gathered(devices, model_parallel: int) -> tuple[list, list]:
    """Every rank's devices, rank-major, and the rank of each: this rank's
    ``devices`` (default :func:`local_devices`) exchanged with
    ``all_gather_object``. Each rank must give as many devices, a multiple
    of ``model_parallel`` (tensor parallelism never crosses a process).
    Every rank raises alike: the checks read the exchanged lists."""
    devs = [str(_device(d)) for d in
            (local_devices() if devices is None else devices)]
    lists: list = [None] * process_count()
    dist.all_gather_object(lists, devs)
    sizes = [len(x) for x in lists]
    if len(set(sizes)) != 1:
        raise ValueError(f"the ranks give {sizes} devices; a mesh across "
                         f"processes takes as many from each")
    if sizes[0] % model_parallel:
        raise ValueError(f"{model_parallel=} must divide the {sizes[0]} "
                         f"devices of one process: tensor parallelism "
                         f"never crosses a process")
    return ([torch.device(d) for x in lists for d in x],
            [r for r, x in enumerate(lists) for _ in x])


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default :func:`local_devices`; a list may repeat one device).
    ``model_parallel`` must divide ``n_devices``; 1 is pure data
    parallelism. Across processes the list is every rank's, rank-major,
    and the mesh spans all of it."""
    if process_count() > 1:
        devs, ranks = _gathered(devices, model_parallel)
    else:
        devs = list(local_devices() if devices is None else devices)
        ranks = None
    n = n_devices or len(devs)
    if n % model_parallel:
        raise ValueError(f"{model_parallel=} must divide {n=}")
    if n > len(devs):
        raise ValueError(f"a mesh of {n=} devices needs {n} devices; "
                         f"{len(devs)} are available")
    shape = (n // model_parallel, model_parallel)
    if ranks is None:
        return Mesh(_grid(devs[:n], shape), (DATA_AXIS, MODEL_AXIS))
    if n != len(devs):
        raise ValueError(f"a mesh across {process_count()} processes spans "
                         f"every rank's devices: {n=} of {len(devs)}")
    return Mesh(_grid(devs, shape), (DATA_AXIS, MODEL_AXIS),
                ranks=np.asarray(ranks).reshape(shape))


def make_hybrid_mesh(dcn_parallel: int | None = None,
                     model_parallel: int = 1, devices=None) -> Mesh:
    """A (dcn, data, model) mesh: the outermost ``dcn`` axis stands for the
    hosts, and the batch is split over (dcn, data). In one process the
    device list is reshaped, ``dcn_parallel`` standing for the host count.
    Across W processes ``dcn`` is W (``dcn_parallel`` may only repeat it):
    rank r drives the whole ``dcn = r`` slab, its devices laid out as JAX's
    per-host granule ``(1, n_local // model_parallel, model_parallel)``."""
    mp = model_parallel
    if process_count() > 1:
        devs, ranks = _gathered(devices, mp)
        n_hosts = dcn_parallel or process_count()
        if len(devs) % n_hosts or (len(devs) // n_hosts) % mp:
            raise ValueError(
                f"dcn={n_hosts} x {model_parallel=} must divide "
                f"{len(devs)} devices")
        if n_hosts != process_count():
            raise ValueError(f"dcn={n_hosts} across {process_count()} "
                             f"processes: rank r drives the dcn = r slab, "
                             f"so dcn is the process count")
        shape = (n_hosts, len(devs) // (n_hosts * mp), mp)
        return Mesh(_grid(devs, shape), (DCN_AXIS, DATA_AXIS, MODEL_AXIS),
                    ranks=np.asarray(ranks).reshape(shape))
    devs = list(local_devices() if devices is None else devices)
    dcn = dcn_parallel or 1
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
    inputs (:func:`put`) have a piece at every position of this rank; the
    outputs of the sharded programs one per chunk, at the model axis's
    first position. Across processes a rank holds only its own pieces, so
    :meth:`gather` and :meth:`numpy` raise there."""

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
    ``jax.device_put(x, sharding)``, each rank giving the same ``x`` and
    placing its own positions' pieces. Each chunk is copied once per
    distinct device; on a device that already holds ``x`` it is a view."""
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
    for pos in mesh.local_positions():
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


def local_batch_positions(mesh: Mesh) -> list[tuple]:
    """The batch positions this rank runs: its share of
    :func:`batch_positions`, in chunk order (all of them with one rank)."""
    local = set(mesh.local_positions())
    return [p for p in batch_positions(mesh) if p in local]


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
