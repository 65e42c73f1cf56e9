"""Device meshes and the collectives of the multi-device paths — port of
``optimal_control_problem_tpu/parallel/mesh.py``.

JAX runs the multi-device paths as ``shard_map`` programs over a
``jax.sharding.Mesh`` and its tests put eight virtual CPU devices in one
process.  Torch has no such mode, and NCCL runs no two ranks of one
communicator on one card, so every per-device function of ``parallel/`` is
written once against the small collective interface of :class:`Shards`,
which a :class:`Mesh` serves in one of two ways:

* **in-process** (``devices`` a torch device, default ``cuda``): the D
  shards of an axis sit on a leading dimension of every local tensor, on
  one device, and each collective is a tensor op — ``psum``/``pmax`` a
  reduction over that dimension broadcast back, ``ppermute`` a roll,
  ``all_gather`` the dimension itself, ``axis_index`` an ``arange``.  This
  is the counterpart of ``--xla_force_host_platform_device_count``, and
  what runs a D-way sharded solve on one card;
* **torch.distributed** (``devices`` a process group, or
  ``"distributed"`` for the default one): one shard per rank, NCCL on the
  GPU and gloo on the CPU.  Each collective is torch's functional one
  (``torch.ops._c10d_functional``) on the process group of its axes,
  which the mesh makes when it is built: ``torch.export`` keeps them as
  op nodes, so a solve exports as one program a rank.

A per-device function sees local tensors whose leading dimension S counts
the shards it holds: S is the mesh size in-process and 1 on a rank (times
the local scenarios of a ``vmap``-ed batch, :meth:`Shards.with_local`).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "Mesh",
    "NamedSharding",
    "Shards",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "initialize_distributed",
]


class Mesh:
    """Named axes over shards: in-process on one device (``group`` None)
    or one shard per rank of a ``torch.distributed`` process group, ranks
    laid out row-major over the axes."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 device: torch.device, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        self.group = group
        self.devices = np.arange(math.prod(shape), dtype=np.int64).reshape(shape)
        self._groups = {}
        if group is not None:
            self._make_axis_groups()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        kind = "torch.distributed" if self.distributed else f"in-process on {self.device}"
        return f"Mesh({self.shape}, {kind})"

    # -- torch.distributed bookkeeping ---------------------------------
    def coords(self) -> dict:
        """This rank's coordinate on every axis (all 0 in-process)."""
        if not self.distributed:
            return {a: 0 for a in self.axis_names}
        import torch.distributed as dist

        idx = np.unravel_index(dist.get_rank(self.group), tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def _make_axis_groups(self):
        """Every axis group a solve can ask for, made by every rank when
        the mesh is built, in one fixed order: the subsets of the axes by
        size, each in layout order, and within a subset one group for
        each coordinate of the other axes, row-major.  A process names
        its groups by a counter (``"1"`` for the first ``new_group``), and
        an exported rank program names the groups it reaches
        (``utils/serialization.export_solver``): a process that builds the
        same meshes in the same order has groups of the same names."""
        import torch.distributed as dist

        mine = self.coords()
        ranks_of = dist.get_process_group_ranks(self.group)
        for k in range(1, len(self.axis_names)):
            for axes in itertools.combinations(self.axis_names, k):
                others = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    pin = dict(zip(others, fixed))
                    members = []
                    for free in itertools.product(*(range(self.shape[a]) for a in axes)):
                        c = {**pin, **dict(zip(axes, free))}
                        flat = np.ravel_multi_index(tuple(c[a] for a in self.axis_names),
                                                    tuple(self.shape.values()))
                        members.append(ranks_of[int(flat)])
                    g = dist.new_group(members)
                    if all(mine[a] == pin[a] for a in others):
                        self._groups[axes] = g

    def axis_group(self, axes: Tuple[str, ...]):
        """The process group of the ranks that differ only on ``axes``
        (the mesh's own group for all of them)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        return self.group if axes == self.axis_names else self._groups[axes]

    def shards(self) -> "Shards":
        """The collective interface over this mesh's axes."""
        return Shards(self, [(a, self.shape[a], not self.distributed) for a in self.axis_names])


class Shards:
    """The collectives a per-device function calls, over local tensors
    whose leading dimension S holds this process's shards.

    ``axes``: ``(name, size, local)`` in layout order; a local axis has
    its ``size`` shards on S, a distributed one a single shard (this
    rank's).  S is the product of the local sizes, row-major.
    """

    def __init__(self, mesh: Mesh, axes):
        self.mesh = mesh
        self.axes = list(axes)
        self.device = mesh.device
        self.S = math.prod(n for _, n, local in self.axes if local)

    def with_local(self, name: str, size: int, after: str) -> "Shards":
        """A view with an extra local axis of ``size`` (JAX's ``vmap`` over
        a local scenario batch) placed after axis ``after``.  Collectives
        never reduce over it: each of its entries is its own problem."""
        i = [a for a, _, _ in self.axes].index(after) + 1
        return Shards(self.mesh, self.axes[:i] + [(name, size, True)] + self.axes[i:])

    def size(self, name: str) -> int:
        return self._axis(name)[1]

    def _axis(self, name):
        for a in self.axes:
            if a[0] == name:
                return a
        raise ValueError(f"mesh has no axis {name!r}: {self.mesh.shape}")

    def _local_shape(self):
        return [n for _, n, local in self.axes if local]

    def _local_dim(self, name):
        """Position of a local axis among the local dims."""
        return [a for a, _, local in self.axes if local].index(name)

    def _split(self, t):
        return t.reshape(self._local_shape() + list(t.shape[1:]))

    # -- collectives ------------------------------------------------------
    def axis_index(self, name: str) -> torch.Tensor:
        """``(S,)`` int64: each shard's coordinate on axis ``name``."""
        _, n, local = self._axis(name)
        if local:
            shape = [1] * len(self._local_shape())
            shape[self._local_dim(name)] = n
            idx = torch.arange(n, device=self.device).reshape(shape)
            return idx.expand(self._local_shape()).reshape(self.S)
        return torch.full((self.S,), self.mesh.coords()[name], dtype=torch.int64,
                          device=self.device)

    def _reduce(self, t, names, op):
        names = (names,) if isinstance(names, str) else tuple(names)
        for a in names:
            self._axis(a)
        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.float32)
        local = [a for a, _, loc in self.axes if loc and a in names]
        if local:
            v = self._split(t)
            dims = [self._local_dim(a) for a in local]
            if op == "sum":
                # An ascending chain over the shards, the order of XLA's
                # CPU all-reduce (torch.sum's blocked order differs by ulps).
                k = len(dims)
                v = v.movedim(dims, list(range(k)))
                v = v.reshape((-1,) + tuple(v.shape[k:]))
                acc = v[0]
                for i in range(1, v.shape[0]):
                    acc = acc + v[i]
                v = acc.reshape((1,) * k + tuple(acc.shape)).movedim(list(range(k)), dims)
            else:
                v = v.amax(dim=dims, keepdim=True)
            t = v.expand(self._local_shape() + list(t.shape[1:])).reshape(t.shape)
        remote = tuple(a for a, _, loc in self.axes if not loc and a in names)
        if remote:  # the collective runs even over one rank
            t = _all_reduce(t, op, self.mesh.axis_group(remote))
        return t.to(dtype) if dtype == torch.bool else t

    def psum(self, t: torch.Tensor, names) -> torch.Tensor:
        """Sum over the shards of ``names`` (one axis or several), the
        result on every one of them."""
        return self._reduce(t, names, "sum")

    def pmax(self, t: torch.Tensor, names) -> torch.Tensor:
        """Maximum over the shards of ``names`` (NaN kept); bools give
        their logical or."""
        return self._reduce(t, names, "max")

    def all_gather(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``(S, ...) -> (S, D, ...)``: every shard of axis ``name``'s
        value, in axis order, on each shard."""
        _, n, local = self._axis(name)
        if local:
            v = self._split(t)
            i = self._local_dim(name)
            k = len(self._local_shape())
            g = v.movedim(i, k - 1).unsqueeze(k - 1)
            g = g.expand(g.shape[: k - 1] + (n,) + g.shape[k:]).movedim(k - 1, i)
            return g.reshape((self.S, n) + tuple(t.shape[1:]))
        g = _all_gather(t, n, self.mesh.axis_group((name,)))
        return g.movedim(0, 1).contiguous()

    def ppermute(self, t: torch.Tensor, name: str, shift: int) -> torch.Tensor:
        """Shard i's value to shard i + shift (mod D) of axis ``name``:
        JAX's ``ppermute`` with ``[(i, (i + shift) % D)]``."""
        _, n, local = self._axis(name)
        if local:
            v = self._split(t)
            return torch.roll(v, shifts=shift, dims=self._local_dim(name)).reshape(t.shape)
        src = (self.mesh.coords()[name] - shift) % n
        return self.all_gather(t, name)[:, src]

    # -- placing global arrays ------------------------------------------
    def shard(self, t: torch.Tensor, spec: Sequence[str]) -> torch.Tensor:
        """A global array -> this process's local tensor ``(S, ...)``.

        ``spec`` names the axis that splits each leading dim of ``t``
        (JAX's ``PartitionSpec``), in layout order; an axis of the view
        that ``spec`` leaves out holds copies.  Each split dim keeps its
        per-shard length in place."""
        t = t.to(self.device)
        order = [a for a, _, _ in self.axes]
        if [a for a in order if a in spec] != list(spec):
            raise ValueError(f"spec {tuple(spec)} is not in the mesh's axis order {order}")
        shape = []
        for d, a in enumerate(spec):
            n = self._axis(a)[1]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of size {t.shape[d]} does not split over {a!r} of {n}")
            shape += [n, t.shape[d] // n]
        v = t.reshape(shape + list(t.shape[len(spec):]))
        # Axis dims to the front (layout order), the per-shard lengths after.
        v = v.permute([2 * i for i in range(len(spec))]
                      + [2 * i + 1 for i in range(len(spec))]
                      + list(range(2 * len(spec), v.dim())))
        coords = self.mesh.coords()
        lead = []
        for a, n, local in self.axes:
            if a in spec:
                i = len(lead)
                if not local:
                    v = v.narrow(i, coords[a], 1)
                lead.append(v.shape[i])
            else:
                v = v.unsqueeze(len(lead))
                if local:
                    v = v.expand(v.shape[: len(lead)] + (n,) + v.shape[len(lead) + 1:])
                lead.append(v.shape[len(lead)])
        # A fresh tensor: on a rank, a view at this rank's offset into the
        # global array fails forward-mode derivatives in an export trace.
        return v.reshape((self.S,) + tuple(v.shape[len(lead):])).clone(
            memory_format=torch.contiguous_format)

    def unshard(self, t: torch.Tensor, spec: Sequence[str]) -> torch.Tensor:
        """The inverse of :meth:`shard`, on every process: the global
        array from the local tensors (gathered from every rank on a
        distributed mesh); of the copies along axes ``spec`` leaves out,
        the first."""
        full = self._gather_all(t)  # (prod sizes in layout order, ...)
        sizes = [n for _, n, _ in self.axes]
        v = full.reshape(sizes + list(t.shape[1:]))
        for i, (a, _, _) in reversed(list(enumerate(self.axes))):
            if a not in spec:
                v = v.select(i, 0)
        k = len(spec)
        # (axis sizes..., per-shard lengths..., rest) -> interleave.
        perm = []
        for i in range(k):
            perm += [i, k + i]
        v = v.permute(perm + list(range(2 * k, v.dim())))
        shape = [v.shape[2 * i] * v.shape[2 * i + 1] for i in range(k)]
        return v.reshape(shape + list(v.shape[2 * k:]))

    def _gather_all(self, t):
        """Local tensors of every process, ``(prod of all sizes, ...)`` in
        layout order."""
        remote = [a for a, _, local in self.axes if not local]
        if not remote:
            return t
        # (remote sizes..., local sizes..., rest) -> layout order.
        rs = [self.size(a) for a in remote]
        ls = self._local_shape()
        v = _all_gather(t, math.prod(rs), self.mesh.axis_group(tuple(remote)))
        v = v.reshape(rs + ls + list(t.shape[1:]))
        names = remote + [a for a, _, local in self.axes if local]
        perm = [names.index(a) for a, _, _ in self.axes]
        v = v.permute(perm + list(range(len(names), v.dim())))
        return v.reshape((math.prod(rs + ls),) + tuple(t.shape[1:]))


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group``: torch's
    functional collective, waited for (out of place; ``torch.export``
    keeps it and its wait as op nodes of the program)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(t.contiguous(), op, group.group_name))


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """``(S, ...) -> (n, S, ...)``: every rank's ``t`` of the ``n``-rank
    ``group`` in group order, as :func:`_all_reduce`."""
    c10d = torch.ops._c10d_functional
    g = c10d.wait_tensor(c10d.all_gather_into_tensor(t.contiguous(), n, group.group_name))
    return g.reshape((n,) + tuple(t.shape))


def make_mesh(
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """A mesh with named axes.

    ``devices``: a torch device (default ``cuda``) for an in-process mesh,
    whose shards all live on it — ``shape`` then says how many (one when a
    single axis gives none, as one card is all the devices there are); or
    a ``torch.distributed`` process group, or ``"distributed"`` for the
    default group, for one shard per rank (``shape`` defaults to the
    group's size on a single axis).  Asking for ``torch.distributed``
    before :func:`initialize_distributed` raises.
    """
    axis_names = tuple(axis_names)
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis names must be distinct: {axis_names}")
    group = None
    if isinstance(devices, str) and devices == "distributed":
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a torch.distributed mesh needs a process group: call "
                "initialize_distributed() (or torch.distributed.init_process_group) first"
            )
        group = dist.group.WORLD
    elif devices is not None and not isinstance(devices, (str, torch.device)):
        import torch.distributed as dist

        if not isinstance(devices, dist.ProcessGroup):
            raise TypeError(f"devices must be a torch device, a process group or "
                            f"'distributed', not {type(devices).__name__}")
        group = devices
    if group is not None:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    else:
        n = None
        device = resolve_device(devices)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (1 if n is None else n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit the axes {axis_names}")
    if n is not None and math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return Mesh(axis_names, shape, device, group)


class NamedSharding(NamedTuple):
    """A mesh and a partition spec (JAX's ``NamedSharding``): ``spec``
    names the axis that splits each leading dim, ``()`` for copies."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` -> this process's local tensor ``(S, ...)``."""
        return self.mesh.shards().shard(t, self.spec)


def batch_sharding(mesh: Mesh, axis: str = "batch") -> NamedSharding:
    """Shard the leading (batch) dimension across the mesh axis."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
    return NamedSharding(mesh, (axis,))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Multi-process start-up on ``torch.distributed.init_process_group``
    (the counterpart of ``jax.distributed.initialize``): NCCL when the
    processes compute on ``cuda`` (the default; each takes card
    ``process_id % device_count``), gloo for ``device="cpu"``.
    ``coordinator_address`` is ``host:port`` of process 0; left out, the
    environment of ``torchrun`` (``MASTER_ADDR``, ``RANK``, ...) is read.
    Call it once per process before making a distributed mesh."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if dev.type == "cuda":
        rank = int(process_id) if process_id is not None else _env_rank()
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def _env_rank() -> int:
    """The local rank ``torchrun`` sets (0 without one)."""
    import os

    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
