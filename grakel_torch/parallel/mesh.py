"""Process groups as meshes: one process a GPU, on ``torch.distributed``.

The counterpart of ``grakel_tpu/parallel/mesh.py``.  The JAX package is
single-controller (one process sees every device of its mesh); the port
runs one process a rank, and every rank calls the same entry point on
the same graphs.  A :class:`Mesh` is a small object: the process group,
this rank, the group's size, this rank's device and the axis name
(``"g"``, kept for signature parity with the JAX functions).

* :func:`distributed_init` joins the world: explicit arguments win,
  else the variables ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); with
  neither it returns False, so single-process callers may call it
  unconditionally.
* :func:`make_mesh` covers the first ``n`` ranks of the world.  With no
  group initialized it builds a world of one over a ``HashStore``, so a
  single process needs no launcher.
* :func:`local_mesh` covers the ranks on this host.

The backend follows the device: NCCL for ``cuda:{LOCAL_RANK}``, gloo
only when the CPU was asked for (``use_device("cpu")`` or ``device=
"cpu"``).  There is no fall back to gloo or to the CPU: a CUDA mesh
needs a card (:func:`grakel_torch.device.resolve_device` raises
without one), and the collectives raise when handed a tensor on another
device type than the mesh's (:func:`check_tensor`).

``python -m grakel_torch.parallel.launch`` spawns gloo or NCCL ranks on
one host; under ``torchrun`` each rank calls :func:`distributed_init`
and :func:`make_mesh` itself.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import current_device, resolve_device

__all__ = ["Mesh", "make_mesh", "local_mesh", "distributed_init",
           "check_tensor", "gather_blocks", "shutdown"]

# process groups made by make_mesh / local_mesh, by (ranks, backend):
# new_group is collective over the whole world, so each is made once
_GROUPS = {}


class Mesh:
    """A 1-D mesh of ranks: ``group`` (the process group), ``ranks`` (its
    members' global ranks, in mesh order), ``rank`` (this process's
    position in the mesh), ``size``, ``device`` (this rank's) and
    ``axis_name``."""

    def __init__(self, group, ranks, rank, device, axis_name="g"):
        self.group = group
        self.ranks = tuple(ranks)
        self.rank = rank
        self.size = len(self.ranks)
        self.device = torch.device(device)
        self.axis_name = axis_name

    @property
    def axis_names(self):
        return (self.axis_name,)

    @property
    def shape(self):
        return {self.axis_name: self.size}

    @property
    def backend(self):
        return dist.get_backend(self.group)

    def global_rank(self, p):
        """The global rank of mesh position ``p`` (mod the size)."""
        return self.ranks[p % self.size]

    def __repr__(self):
        return ("Mesh(size=%d, rank=%d, device=%s, backend=%s, axis=%r)"
                % (self.size, self.rank, self.device, self.backend,
                   self.axis_name))


def _rank_device(device=None):
    """This rank's device: ``device``, else the ambient device, else
    ``cuda:{LOCAL_RANK}``.  Raises without a card when CUDA is asked
    for (never falls back)."""
    if device is None and current_device() is None:
        device = "cuda:%d" % int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _backend(dev):
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError("no process-group backend for device %s" % dev)


def check_tensor(mesh, t):
    """Raise unless tensor ``t`` lies on the mesh's device type (a gloo
    group is not handed CUDA tensors, nor NCCL host ones: no staging)."""
    if t.device.type != mesh.device.type:
        raise ValueError("a %s mesh (%s) was handed a tensor on %s; move "
                         "the data to the mesh's device first"
                         % (mesh.device, mesh.backend, t.device))
    return t


def gather_blocks(mesh, t):
    """Every rank's ``t`` (one shape on every rank) stacked along dim 0
    in mesh order, on every rank: one ``all_gather_into_tensor``, run
    at every mesh size (a world of one copies).  ``gather_blocks.calls``
    counts them."""
    check_tensor(mesh, t)
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    gather_blocks.calls += 1
    return out


gather_blocks.calls = 0


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, device=None, local_rank=None):
    """Join the process group of this process's world.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; ``num_processes`` the world size;
    ``process_id`` this process's rank.  Explicit arguments win, else
    ``torchrun``'s variables (``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``).  The backend follows
    this rank's device (:func:`_rank_device`): NCCL on ``cuda:{local
    rank}`` (made current), gloo when the CPU is asked for.

    Returns False, doing nothing, when neither arguments nor variables
    are present, and True once the group is up (also when it already
    was)."""
    if dist.is_initialized():
        return True
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = "env://"
    if addr is None and num_processes is None:
        return False
    if "://" not in addr:
        addr = "tcp://" + addr
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if local_rank is not None:
        os.environ["LOCAL_RANK"] = str(int(local_rank))
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method=addr,
                            world_size=world, rank=rank)
    return True


def _group(ranks, backend):
    """The process group over global ``ranks`` with ``backend``: the
    default group when it is that, else one made once by
    ``new_group`` (a collective of the whole world)."""
    world = dist.get_world_size()
    if ranks == tuple(range(world)) and dist.get_backend() == backend:
        return dist.group.WORLD
    key = (ranks, backend)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), backend=backend)
    return _GROUPS[key]


def make_mesh(n_devices=None, axis_name="g", device=None):
    """1-D mesh over the first ``n_devices`` ranks of the world (all of
    them by default), on this rank's device (``device``, else the
    ambient device, else ``cuda:{LOCAL_RANK}``).

    With no process group initialized, makes a world of one over a
    ``HashStore`` (no launcher, no port).  Every rank of the world must
    call it (group creation is collective); a rank outside the first
    ``n_devices`` gets a ValueError."""
    dev = _rank_device(device)
    backend = _backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError("requested %d ranks but the world has %d"
                         % (n, world))
    ranks = tuple(range(n))
    group = _group(ranks, backend)
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError("rank %d is outside the mesh of the first %d "
                         "ranks" % (me, n))
    return Mesh(group, ranks, ranks.index(me), dev, axis_name)


def local_mesh(axis_name="g", device=None):
    """Mesh over the ranks on this host: ``LOCAL_WORLD_SIZE`` (as
    ``torchrun`` sets it) consecutive ranks from ``RANK - LOCAL_RANK``,
    or the whole world when it is not set.  Every rank of the world must
    call it."""
    dev = _rank_device(device)
    if not dist.is_initialized() or "LOCAL_WORLD_SIZE" not in os.environ:
        return make_mesh(None, axis_name, dev)
    backend = _backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world, me = dist.get_world_size(), dist.get_rank()
    size = int(os.environ["LOCAL_WORLD_SIZE"])
    if world % size:
        raise ValueError("LOCAL_WORLD_SIZE %d does not divide the world "
                         "size %d" % (size, world))
    mine = None
    for lo in range(0, world, size):   # every host's group, on every rank
        ranks = tuple(range(lo, lo + size))
        group = _group(ranks, backend)
        if me in ranks:
            mine = Mesh(group, ranks, me - lo, dev, axis_name)
    return mine


def shutdown():
    """Destroy the process groups: every mesh's and the world's (a no-op
    when none is up).  A process that made a mesh calls it before it
    exits; afterwards :func:`make_mesh` starts anew."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
