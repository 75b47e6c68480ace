"""Logical-axis sharding registry: the single source of truth mapping
logical tensor axes ("embed", "heads", "batch", ...) to mesh axes
("pod", "data", "model").  Port of the reference's
``repro.dist.sharding``.

Every ``PartitionSpec`` of the port (the parameter trees of
``models/layers.py``, the activation layouts of ``models/model.py`` /
``attention.py`` / ``moe.py``, the cache layouts) comes from one
``AxisRules`` table through ``resolve_spec``, so a profile change
(serving TP vs. pure-DP training) is a one-table swap via
``set_active_rules``.

Resolution semantics (``resolve_spec``), the reference's:
  * each logical name maps to an ordered tuple of *candidate* mesh axes;
  * candidates absent from the mesh are skipped (the same table works
    for single-pod ``(data, model)`` and multi-pod ``(pod, data, model)``
    meshes);
  * a mesh axis is consumed at most once per spec, earlier dims win;
  * a candidate whose size does not divide the remaining dim extent is
    skipped: the divisibility fallback, which degrades to a partial or
    fully replicated layout instead of erroring (6 kv heads on a
    16-wide model axis stay replicated).  Nothing is ever padded.

The reference's specs are ``jax.sharding.PartitionSpec`` and its
``NamedSharding`` places arrays for GSPMD.  Here ``PartitionSpec`` is
the port's own tuple of entries (None, an axis, or a tuple of axes)
and ``NamedSharding(mesh, spec)`` is what explicit SPMD needs of it: a
rank's slice of a global tensor, the local shape, and the gather of the
local blocks back to the whole.  ``constrain`` is the identity without
a mesh, as the reference's; under one it moves a local block from the
layout it has to the one the logical names resolve to.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch import mesh as _mesh

AxisCandidates = Union[str, Sequence[str], None]


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), a mesh axis, or a tuple of
    axes (the first the slowest).  Equal to a plain tuple of the same
    entries; trailing replication is trimmed by ``resolve_spec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class AxisRules:
    """Immutable ordered table: logical axis name -> candidate mesh axes."""

    def __init__(self, rules: Mapping[str, AxisCandidates]):
        table = {}
        for name, cand in dict(rules).items():
            if cand is None:
                table[name] = ()
            elif isinstance(cand, str):
                table[name] = (cand,)
            else:
                table[name] = tuple(cand)
        self._table = table

    def get(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        return self._table.get(name, ())

    def extend(self, **updates: AxisCandidates) -> "AxisRules":
        """New table with ``updates`` merged over this one."""
        merged = dict(self._table)
        merged.update(updates)
        return AxisRules(merged)

    def items(self):
        return self._table.items()

    def __contains__(self, name):
        return name in self._table

    def __eq__(self, other):
        return isinstance(other, AxisRules) and self._table == other._table

    def __hash__(self):
        return hash(tuple(sorted((k, v) for k, v in self._table.items())))

    def __repr__(self):
        body = ", ".join(f"{k}={v}" for k, v in self._table.items())
        return f"AxisRules({body})"


# Serving / tensor-parallel profile: weights and caches split over
# ``model``, batch over ``data`` (and ``pod`` when present), sequence
# parallelism between blocks on ``model``.
DEFAULT_RULES = AxisRules({
    # activations
    "batch": ("pod", "data"),
    "attn_batch": ("pod", "data", "model"),   # heads not shardable: spread B
    "seq": None,
    "seq_sp": ("model",),                     # inter-block sequence parallel
    # params
    "embed": None,
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "latent": None,
    "experts": ("model",),
    "vocab": ("model",),
    "layers": None,                           # scan axis, never sharded
    "conv": None,
    # decode caches
    "cache_batch": ("pod", "data"),
    "cache_seq": ("model",),                  # flash-decoding seq shards
})

# Pure data-parallel profile for models small enough to replicate:
# params replicated, the batch spread over every mesh axis.
DP_RULES = AxisRules({
    "batch": ("pod", "data", "model"),
    "attn_batch": ("pod", "data", "model"),
    "seq": None,
    "seq_sp": None,
    "embed": None,
    "mlp": None,
    "heads": None,
    "kv": None,
    "latent": None,
    "experts": ("model",),                    # EP stays: dispatch is local
    "vocab": None,
    "layers": None,
    "conv": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": ("model",),
})

# Params above this count cannot replicate per device: use the TP table.
DP_PARAM_THRESHOLD = 10e9


def rules_for(n_params: float,
              threshold: float = DP_PARAM_THRESHOLD) -> AxisRules:
    """Train/prefill rule table by parameter count: small models take
    the pure-DP profile, large ones the tensor-parallel DEFAULT_RULES."""
    return DP_RULES if n_params < threshold else DEFAULT_RULES


_ACTIVE_RULES = DEFAULT_RULES


def active_rules() -> AxisRules:
    """The process-wide rule table used when no explicit table is passed."""
    return _ACTIVE_RULES


def set_active_rules(rules: AxisRules) -> AxisRules:
    """Install ``rules`` as the active table; returns the previous one."""
    global _ACTIVE_RULES
    if not isinstance(rules, AxisRules):
        raise TypeError(f"set_active_rules takes an AxisRules, got {rules!r}")
    prev = _ACTIVE_RULES
    _ACTIVE_RULES = rules
    return prev


class use_rules:
    """Context manager: ``with use_rules(DP_RULES): ...`` scopes a table."""

    def __init__(self, rules: AxisRules):
        self._rules = rules

    def __enter__(self):
        self._prev = set_active_rules(self._rules)
        return self._rules

    def __exit__(self, *exc):
        set_active_rules(self._prev)
        return False


def logical_to_mesh(logical: Sequence[Optional[str]], mesh,
                    rules: Optional[AxisRules] = None) -> Tuple:
    """Map logical names to mesh-axis assignments (no shape knowledge:
    divisibility is NOT checked; use resolve_spec for a final spec).

    Returns one entry per logical name: None, a mesh axis, or a tuple
    of mesh axes.  Mesh axes are consumed left-to-right at most once.
    """
    rules = rules or active_rules()
    mesh_axes = dict(mesh.shape)
    used = set()
    out = []
    for name in logical:
        picked = []
        for cand in rules.get(name):
            if cand in mesh_axes and cand not in used:
                picked.append(cand)
                used.add(cand)
        out.append(None if not picked
                   else (picked[0] if len(picked) == 1 else tuple(picked)))
    return tuple(out)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, rules: Optional[AxisRules] = None) -> PartitionSpec:
    """Resolve (shape, logical axes) to a PartitionSpec for ``mesh``.

    Greedy per-dim assignment with the divisibility fallback described
    in the module docstring; axes of size 1 are skipped (they partition
    nothing and would block reuse elsewhere).
    """
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical names "
                         f"{tuple(logical)} differ in length")
    rules = rules or active_rules()
    mesh_axes = dict(mesh.shape)
    used = set()
    entries = []
    for extent, name in zip(shape, logical):
        picked = []
        remaining = int(extent)
        for cand in rules.get(name):
            size = mesh_axes.get(cand)
            if size is None or size <= 1 or cand in used:
                continue
            if remaining % size != 0:
                continue                      # divisibility fallback
            picked.append(cand)
            used.add(cand)
            remaining //= size
        entries.append(None if not picked
                       else (picked[0] if len(picked) == 1
                             else tuple(picked)))
    while entries and entries[-1] is None:    # trim trailing replication
        entries.pop()
    return PartitionSpec(*entries)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A ``PartitionSpec`` on a mesh: which block of a global tensor each
    rank holds.  Dim i splits into ``mesh.count(spec[i])`` equal blocks;
    this rank holds block ``mesh.index(spec[i])``."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    def _entries(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec!r} has more entries than {ndim} "
                             "dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_counts(self, ndim: int) -> Tuple[int, ...]:
        return tuple(self.mesh.count(_entry_axes(e))
                     for e in self._entries(ndim))

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, k in zip(global_shape, self.shard_counts(len(global_shape))):
            if n % k:
                raise ValueError(f"{tuple(global_shape)} does not split by "
                                 f"{self.spec!r} on {dict(self.mesh.shape)}")
            out.append(n // k)
        return tuple(out)

    def global_shape(self, local_shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n * k for n, k in zip(
            local_shape, self.shard_counts(len(local_shape))))

    def slices(self, global_shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a tensor of ``global_shape``."""
        local = self.local_shape(global_shape)
        out = []
        for n, e in zip(local, self._entries(len(global_shape))):
            i = self.mesh.index(_entry_axes(e))
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def shard(self, full):
        """This rank's block of the global ``full`` (a tensor or a numpy
        array): a copy of its own, so the global tensor's memory is not
        kept alive by it."""
        block = full[self.slices(full.shape)]
        if isinstance(block, torch.Tensor):
            return block.clone(memory_format=torch.contiguous_format)
        return block.copy()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block (every rank gets
        it)."""
        out = local
        for dim, e in enumerate(self._entries(local.ndim)):
            axes = _entry_axes(e)
            if axes:
                out = _mesh.all_gather(self.mesh, out, axes, dim)
        return out


def named_sharding(shape, logical, mesh,
                   rules: Optional[AxisRules] = None) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(shape, logical, mesh, rules))


def factored_moment_specs(shape: Sequence[int],
                          logical: Sequence[Optional[str]], mesh,
                          rules: Optional[AxisRules] = None
                          ) -> Tuple[PartitionSpec, PartitionSpec]:
    """(row, col) PartitionSpecs for Adafactor's factored second moments
    of a parameter with ``(shape, logical)``: row drops the last axis,
    col drops the second-to-last.  Each moment is re-resolved through
    ``resolve_spec`` on its own (shape, logical), not sliced out of the
    parameter's spec: dropping a dim frees the mesh axis it consumed,
    and divisibility is re-checked against the moment's extents."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical names "
                         f"{tuple(logical)} differ in length")
    row = resolve_spec(tuple(shape[:-1]), tuple(logical[:-1]), mesh, rules)
    col = resolve_spec(tuple(shape[:-2]) + tuple(shape[-1:]),
                       tuple(logical[:-2]) + tuple(logical[-1:]),
                       mesh, rules)
    return row, col


def relayout(x: torch.Tensor, mesh, src: Sequence, dst: Sequence
             ) -> torch.Tensor:
    """This rank's block of a tensor in layout ``src`` (a PartitionSpec)
    moved to layout ``dst``, dim by dim: a dim sharded alike is kept;
    one whose ``dst`` axes extend its ``src`` axes is sliced further;
    one whose ``src`` axes extend its ``dst`` axes is all-gathered over
    the extra axes; any other change is gathered whole and sliced
    again."""
    s_ent = NamedSharding(mesh, src)._entries(x.ndim)
    d_ent = NamedSharding(mesh, dst)._entries(x.ndim)
    for dim, (se, de) in enumerate(zip(s_ent, d_ent)):
        sa, da = _entry_axes(se), _entry_axes(de)
        if sa == da:
            continue
        if da[:len(sa)] == sa:
            extra = da[len(sa):]
        else:
            if sa[:len(da)] == da:
                x = _mesh.all_gather(mesh, x, sa[len(da):], dim)
                continue
            x = _mesh.all_gather(mesh, x, sa, dim)
            extra = da
        n = x.shape[dim] // mesh.count(extra)
        x = x.narrow(dim, mesh.index(extra) * n, n)
    return x.contiguous()


def constrain(x, mesh, logical: Sequence[Optional[str]],
              rules: Optional[AxisRules] = None, *, layout=None,
              global_shape: Optional[Sequence[int]] = None):
    """``x`` moved to the layout ``logical`` resolves to; the identity
    when mesh is None (as the reference's).

    Under a mesh ``x`` is this rank's block in ``layout`` (a
    PartitionSpec; None: ``x`` is the whole tensor), and the global
    shape is ``global_shape`` or is read off ``x`` and ``layout``.  A
    block already in the resolved layout is checked and returned as it
    is; otherwise ``relayout`` moves it."""
    if mesh is None:
        return x
    src = NamedSharding(mesh, layout or ())
    full_shape = (tuple(global_shape) if global_shape is not None
                  else src.global_shape(x.shape))
    if src.local_shape(full_shape) != tuple(x.shape):
        raise ValueError(f"a block of {tuple(x.shape)} is not {layout!r} "
                         f"of {full_shape}")
    return relayout(x, mesh, src.spec,
                    resolve_spec(full_shape, logical, mesh, rules))
