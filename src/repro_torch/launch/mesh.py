"""Meshes of ``torch.distributed`` ranks and their staged collectives.
Port of the reference's ``repro.launch.mesh``.

The reference names its devices by a ``jax`` mesh and lets GSPMD place
the collectives.  Torch eager has no GSPMD, so the port runs explicit
SPMD: one process a rank, each holding only its own block of every
sharded tensor, and the collectives called by hand over the process
group of one mesh axis.  ``Mesh`` is that mesh: its axis names and
sizes (``shape``, as the reference's ``mesh.shape`` reads), this
process's rank, its coordinates (row-major: the last axis fastest, the
device order of ``jax.make_mesh`` on host devices), its device, the
collective backend and one process group a line along each axis.

  make_host_mesh(model=1)        (n // model, model) over the n ranks of
                                 this run (or some of them), axes
                                 ("data", "model")
  make_production_mesh(...)      a shape-only (16, 16) or (2, 16, 16)
                                 mesh for spec resolution (no ranks)
  make_dry_mesh(names, sizes, r) rank r of a mesh with no processes
                                 behind it, on the meta device (the dry
                                 run, ``launch/dryrun.py``)

The collectives (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``) take one axis name or a tuple of them; over several
axes they run axis by axis, the last (fastest) first.  Over gloo on a
CUDA rank (several ranks sharing one card: nccl refuses that) each
collective stages its buffers through pinned host memory
(``Mesh.staged``).  Data movement runs on the raw bits, so bf16
travels as bytes; a bf16 or fp16 sum is taken in fp32 and cast back.
``record_collectives()`` counts the calls, bytes, seconds and ring-model
wire bytes (``roofline.wire_bytes``) of each kind (a device sync before
each timed call).  Each collective is recorded for autograd with its
adjoint as its backward: an all-gather's is the reduce-scatter of the
gradients and a reduce-scatter's the all-gather, an all-reduce sum and
an all-to-all are their own (a max takes no gradient), so a forward
over a mesh differentiates across the ranks (``train/loop.py`` states
how a train step seeds and sums the result).  On a dry mesh a collective moves nothing: it returns
an empty meta tensor of the shape and dtype the real one returns, and
is counted as a real rank counts it, with 0 seconds.

``init_distributed`` / ``rank_device`` are the launch path the
distributed SpMM (``grblas.dist``) already used; its 1-D
``device_mesh`` is this mesh with one axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import roofline as R

# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ``torch.distributed`` ranks (or one process).

    ``groups`` maps each axis of more than one rank to the process group
    of this rank's line along it (None: the default group, when the axis
    spans every rank).  A mesh without ranks (``abstract``) serves spec
    resolution only; its collectives raise.  A ``dry`` mesh is one rank
    of a mesh without processes, on the meta device: its collectives
    return meta tensors and are counted (``make_dry_mesh``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict,
                                                  compare=False)
    abstract: bool = False
    dry: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.sizes)

    @property
    def axis(self) -> str:
        """The first axis (a 1-D mesh's only one)."""
        return self.axis_names[0]

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, axes: Axes) -> int:
        """This rank's position along ``axes`` (one or several, the
        first the slowest); 0 for an axis the mesh lacks."""
        c = self.coords
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape.get(a, 1) + c.get(a, 0)
        return idx

    def count(self, axes: Axes) -> int:
        """The ranks along ``axes`` (1 for an axis the mesh lacks)."""
        return math.prod(self.shape.get(a, 1) for a in _axes(axes))


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ------------------------------------------------------------ launch path

def rank_device(device: DeviceLike = None, rank: int = 0,
                world_size: int = 1) -> Tuple[torch.device, str]:
    """This rank's device and the collective backend that goes with it.

    ``device`` names the type ("cuda", the default, or "cpu").  A CUDA
    rank computes on card ``LOCAL_RANK mod device_count``; when every
    rank of the host has a card of its own the backend is nccl, else
    (ranks sharing a card, or CPU ranks) gloo."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    n_cards = torch.cuda.device_count()
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    card = torch.device("cuda", local_rank % n_cards)
    return card, ("nccl" if n_cards >= local_size else "gloo")


def is_distributed_initialized() -> bool:
    """Whether torch.distributed is available and its default process
    group is initialized in this process."""
    return tdist.is_available() and tdist.is_initialized()


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: DeviceLike = None) -> bool:
    """Guarded ``torch.distributed.init_process_group``.

    Resolves (init_method, world_size, rank) from the arguments or the
    standard ``env://`` variables (MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE, RANK) and initializes once, with the backend
    ``rank_device`` names for ``device``.  One process (no rendezvous
    configured, or world_size <= 1) and an already-initialized process
    are no-ops.  Returns True iff this call initialized."""
    if is_distributed_initialized():
        return False
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None or not world_size or world_size <= 1:
        return False
    rank = 0 if rank is None else rank
    _, backend = rank_device(device, rank, world_size)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank,
                             timeout=COLLECTIVE_TIMEOUT)
    return True


def _world(device: DeviceLike) -> Tuple[int, int, torch.device,
                                        Optional[str]]:
    if is_distributed_initialized():
        size, rank = tdist.get_world_size(), tdist.get_rank()
        dev, _ = rank_device(device, rank, size)
        return size, rank, dev, str(tdist.get_backend())
    return 1, 0, resolve_device(device), None


def build_mesh(axis_names: Sequence[str], sizes: Sequence[int],
               device: DeviceLike = None,
               ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A mesh of ``sizes`` over the ranks of this run (initialized first
    by ``init_distributed``), one process group a line along each axis
    of more than one rank.  ``ranks`` (default: every rank, in order)
    are the run's ranks the mesh spans, in mesh order; every rank of the
    run calls this and makes every group, in one order, as
    ``new_group`` requires, and a rank outside ``ranks`` gets None.  A
    CUDA rank's card becomes the current device."""
    init_distributed(device=device)
    world, rank, dev, backend = _world(device)
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if math.prod(sizes) != len(ranks):
        raise ValueError(f"a mesh of {dict(zip(axis_names, sizes))} needs "
                         f"{math.prod(sizes)} ranks; it was given "
                         f"{len(ranks)}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups: Dict[str, Any] = {}
    for i, name in enumerate(axis_names):
        if sizes[i] == 1:
            continue
        stride = math.prod(sizes[i + 1:])
        for base in range(len(ranks)):
            if (base // stride) % sizes[i]:
                continue                        # not the line's first rank
            line = [ranks[base + j * stride] for j in range(sizes[i])]
            if line == list(range(world)):
                g = None                        # the default group
            else:
                g = tdist.new_group(line)
            if rank in line:
                groups[name] = g
    if rank not in ranks:
        return None
    return Mesh(axis_names, sizes, ranks.index(rank), dev, backend, groups)


def make_host_mesh(model: int = 1, device: DeviceLike = None,
                   ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """(n // model, model) named ("data", "model") over the n ranks of
    this run (one process: (1, 1)), or over ``ranks`` of them (a rank
    outside them gets None).  Prints the mesh."""
    init_distributed(device=device)
    n = _world(device)[0] if ranks is None else len(ranks)
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    mesh = build_mesh(("data", "model"), (n // model, model), device, ranks)
    if mesh is not None:
        print(f"make_host_mesh: rank {mesh.rank} of {n} at {mesh.coords} "
              f"on {mesh.device}, collectives over "
              f"{mesh.backend or 'none (one process)'}"
              + (", staged through pinned host memory" if mesh.staged
                 else ""), flush=True)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's v5e pod mesh as shapes only: 16 x 16 = 256 chips a
    pod, 2 pods = 512.  ``data`` carries DP/FSDP, ``model`` TP/EP/SP and
    ``pod`` (multi-pod only) pure DP.  It has no ranks: it serves
    ``resolve_spec`` and the trees built on it."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), abstract=True)
    return Mesh(("data", "model"), (16, 16), abstract=True)


def make_dry_mesh(axis_names: Sequence[str], sizes: Sequence[int],
                  rank: int = 0) -> Mesh:
    """Rank ``rank`` of a mesh of ``sizes`` with no processes behind it,
    on the meta device: the dry run traces one rank's step on it.  Its
    collectives move nothing and return meta tensors of the shapes and
    dtypes the real ones return, each counted under
    ``record_collectives``."""
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    if len(axis_names) != len(sizes) or not 0 <= rank < math.prod(sizes):
        raise ValueError(f"rank {rank} of a mesh of "
                         f"{dict(zip(axis_names, sizes))}")
    return Mesh(axis_names, sizes, rank, torch.device("meta"), dry=True)


# ------------------------------------------------------------ collectives

@dataclasses.dataclass
class CollectiveStats:
    """Calls, bytes (each rank's payload), host seconds and wire bytes
    (the ring model's, a device) by kind."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    wire: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float,
            wire: float = 0.0) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds
        self.wire[kind] = self.wire.get(kind, 0.0) + wire


_STATS: Optional[CollectiveStats] = None


@contextlib.contextmanager
def record_collectives():
    """Count every collective of the block into a ``CollectiveStats``
    (yielded).  Each counted call syncs the device first, so its seconds
    are its own, not the kernels queued before it."""
    global _STATS
    prev, _STATS = _STATS, CollectiveStats()
    try:
        yield _STATS
    finally:
        _STATS = prev


def _lines(mesh: Mesh, axes: Axes):
    """(group, size) of each axis of ``axes`` with more than one rank,
    the last axis first."""
    if mesh.abstract:
        raise RuntimeError("a shape-only mesh runs no collective")
    out = []
    for a in reversed(_axes(axes)):
        n = mesh.shape.get(a, 1)
        if n > 1:
            out.append((mesh.groups.get(a), n))
    return out


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the collective moves it: contiguous, 16-bit floats
    as their bytes (gloo's type dispatch varies for them)."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16) and t.ndim:
        t = t.view(torch.uint8)
    return t


def _out_bytes(kind: str, nbytes: int, n: int) -> float:
    """The output bytes of one line's collective on an ``nbytes``
    payload over ``n`` ranks (a reduce-scatter's: the scattered part)."""
    if kind == "all_gather":
        return nbytes * n
    if kind == "reduce_scatter":
        return nbytes / n
    return nbytes


def _run(mesh: Mesh, kind: str, t: torch.Tensor, fn, sizes,
         out_shape=tuple) -> torch.Tensor:
    """``fn(wire tensor, empty) -> wire tensor`` on ``t``'s bits, staged
    through pinned host memory where the mesh says so (``empty(shape)``
    makes a buffer beside the wire tensor, pinned there), counted when
    recording, with the ring model's wire bytes over lines of ``sizes``
    ranks.  On a dry mesh ``fn`` does not run: the result is an empty
    meta tensor of ``out_shape(wire shape)``."""
    dtype = t.dtype
    stats = _STATS
    if stats is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    w = _wire(t)
    if mesh.dry:
        out = torch.empty(out_shape(w.shape), dtype=w.dtype, device="meta")
    else:
        if mesh.staged:
            w = torch.empty(w.shape, dtype=w.dtype,
                            pin_memory=True).copy_(w)

        def empty(shape):
            return torch.empty(shape, dtype=w.dtype, device=w.device,
                               pin_memory=mesh.staged)

        out = fn(w, empty)
        if mesh.staged:
            out = out.to(mesh.device, non_blocking=True)
    if dtype != out.dtype and out.dtype == torch.uint8:
        out = out.view(dtype)
    if stats is not None:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        nbytes = t.numel() * t.element_size()
        wire = sum(R.wire_bytes(kind, _out_bytes(kind, nbytes, n), n)
                   for n in sizes)
        stats.add(kind, nbytes, 0.0 if mesh.dry
                  else time.perf_counter() - t0, wire)
    return out


class _Adjoint(torch.autograd.Function):
    """A collective ``fwd`` whose backward is the collective ``bwd``, its
    adjoint: autograd then differentiates through the ranks, each rank's
    backward calling ``bwd`` where its forward called ``fwd`` (the same
    order on every rank, as the forward's)."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return fwd(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


def _adjoint(t: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``fwd(t)``, recorded for autograd with ``bwd`` as its backward
    where a gradient flows through ``t``."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Adjoint.apply(t, fwd, bwd)
    return fwd(t)


def _all_reduce(mesh: Mesh, t: torch.Tensor, lines, op: str) -> torch.Tensor:
    red = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    dtype = t.dtype
    low = dtype in (torch.bfloat16, torch.float16)
    x = t.to(torch.float32) if low else t

    def fn(w, empty):
        w = w if mesh.staged else w.clone()     # a staged w is a copy
        for g, _ in lines:
            tdist.all_reduce(w, op=red, group=g)
        return w

    out = _run(mesh, "all_reduce", x, fn, [n for _, n in lines])
    return out.to(dtype) if low else out


def all_reduce(mesh: Mesh, t: torch.Tensor, axes: Axes,
               op: str = "sum") -> torch.Tensor:
    """The sum (or "max") of ``t`` over the ranks along ``axes``, equal
    bits on every rank.  A 16-bit float sums in fp32.  The sum's
    gradient is the sum of the ranks' gradients (its adjoint); a max
    takes no gradient."""
    lines = _lines(mesh, axes)
    if not lines:
        return t
    if op != "sum" and torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"no gradient through an all_reduce {op!r}: "
                           "detach its input")
    return _adjoint(t, lambda x: _all_reduce(mesh, x, lines, op),
                    lambda g: _all_reduce(mesh, g, lines, "sum"))


def _gather_line(mesh: Mesh, t: torch.Tensor, g, n: int,
                 dim: int) -> torch.Tensor:
    def fn(w, empty):
        buf = empty((n,) + tuple(w.shape))
        tdist.all_gather(list(buf.unbind(0)), w, group=g)
        return buf

    blocks = _run(mesh, "all_gather", t, fn, [n], lambda s: (n,) + tuple(s))
    return (blocks.reshape((-1,) + tuple(blocks.shape[2:])) if dim == 0
            else torch.cat(blocks.unbind(0), dim=dim))


def _a2a_line(mesh: Mesh, t: torch.Tensor, g, n: int,
              kind: str) -> torch.Tensor:
    def fn(w, empty):
        recv = empty(w.shape)
        tdist.all_to_all_single(recv, w, group=g)
        return recv

    return _run(mesh, kind, t, fn, [n])


def _scatter_line(mesh: Mesh, t: torch.Tensor, g, n: int,
                  dim: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    blocks = torch.stack(t.chunk(n, dim=dim))        # (n, ...)
    recv = _a2a_line(mesh, blocks, g, n, "reduce_scatter")
    acc = recv.to(torch.float32) if recv.dtype in (
        torch.bfloat16, torch.float16) else recv
    return acc.sum(0).to(t.dtype)


def all_gather(mesh: Mesh, t: torch.Tensor, axes: Axes,
               dim: int = 0) -> torch.Tensor:
    """Every rank's block along ``axes`` concatenated on ``dim`` in mesh
    order (the first axis the slowest).  Each axis gathers into an (n,
    ...) buffer of the blocks, and the blocks are laid along ``dim`` on
    the device.  Its gradient is the reduce-scatter of the ranks'
    gradients, axis by axis in the reverse order."""
    dim = dim % t.ndim if t.ndim else 0
    for g, n in _lines(mesh, axes):
        t = _adjoint(
            t, lambda x, g=g, n=n: _gather_line(mesh, x, g, n, dim),
            lambda y, g=g, n=n: _scatter_line(mesh, y, g, n, dim))
    return t


def all_to_all(mesh: Mesh, t: torch.Tensor, axis: str,
               kind: str = "all_to_all") -> torch.Tensor:
    """Equal-split all_to_all along dim 0 over one axis: block s of the
    result is what the axis's rank s sent this rank.  It is its own
    adjoint: the gradient goes back by the same exchange."""
    lines = _lines(mesh, axis)
    if not lines:
        return t
    (g, n), = lines
    return _adjoint(t, lambda x: _a2a_line(mesh, x, g, n, kind),
                    lambda y: _a2a_line(mesh, y, g, n, kind))


def reduce_scatter(mesh: Mesh, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``'s ranks of ``t``, of which this rank keeps
    block ``index(axis)`` along ``dim``: an all_to_all of the blocks, then
    the sum of the ones received in rank order (fp32 for 16-bit floats).
    Its gradient is the all-gather of the ranks' gradients."""
    lines = _lines(mesh, axis)
    if not lines:
        return t
    (g, n), = lines
    dim = dim % t.ndim
    return _adjoint(t, lambda x: _scatter_line(mesh, x, g, n, dim),
                    lambda y: _gather_line(mesh, y, g, n, dim))
