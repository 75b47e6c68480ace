"""Carry state across from the reference: plain numpy in, port objects out.

The tests feed both packages identical inputs through here: a host COO
triple (what ``repro``'s ``SparseMatrix.host_coo()`` returns) with its
shape and layout keyword arguments becomes a port ``SparseMatrix``, and
start blocks, eigenvector guesses and centroids (``U0``, ``X0``, ``C0``)
become tensors, and the reference's LM parameter tree becomes the
port's ``state_dict`` (``lm_state_dict``), or under a mesh this rank's
blocks of it (``shard_state_dict``; ``gather_state_dict`` puts the
blocks of every rank back together).  Nothing here imports ``repro``:
the inputs are numpy arrays, whichever package made them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.grblas.containers import SparseMatrix


def sparse_matrix(coo: Tuple, shape: Tuple[int, int], *,
                  device: DeviceLike = None, dtype=None,
                  **layout) -> SparseMatrix:
    """A port SparseMatrix from a host (rows, cols, vals) triple.  ``dtype``
    defaults to the dtype of ``vals``; ``layout`` passes through to
    ``SparseMatrix.from_coo`` (build_ell, build_sellcs, sell_c, ...)."""
    rows, cols, vals = (np.asarray(a) for a in coo)
    dtype = vals.dtype if dtype is None else dtype
    return SparseMatrix.from_coo(rows, cols, vals, shape, dtype=dtype,
                                 device=device, **layout)


def tensor(a, *, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A contiguous tensor copy of a host array (U0, X0, C0, ...)."""
    a = np.array(a)                    # a writable, contiguous copy
    dt = torch_dtype(a.dtype if dtype is None else dtype)
    return torch.as_tensor(a, device=resolve_device(device)).to(dt)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor."""
    return t.detach().cpu().numpy()


def lm_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's LM ``state_dict`` from the reference's parameter tree
    (nested dicts of arrays).  The reference stacks the blocks of a
    layer scan on a leading axis (``params["blocks"]["attn"]["wq"]`` is
    (L, d, H, hd)); the port holds one block per layer, so layer i's
    leaf becomes ``blocks.i.attn.wq``; deepseek's leading dense layers
    (``dense_blocks``) and whisper's encoder layers (``enc_blocks``)
    split the same way.  Every other leaf (``pos_embed``, ``enc_pos``,
    a norm's ``scale`` and ``bias``) carries across as it is.  Dtypes
    are kept."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, layer=None):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{name}.", layer)
                continue
            a = np.asarray(sub)
            a = np.array(a if layer is None else a[layer])   # a copy
            out[f"{prefix}{name}"] = torch.from_numpy(a)

    for name, sub in params.items():
        if name in ("blocks", "dense_blocks", "enc_blocks"):
            n = np.shape(next(_leaves(sub)))[0]
            for i in range(n):
                walk(sub, f"{name}.{i}.", i)
        elif isinstance(sub, Mapping):
            walk(sub, f"{name}.")
        else:
            out[name] = torch.from_numpy(np.array(sub))
    return out


def shard_state_dict(params: Mapping, cfg, mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of every parameter, by ``state_dict`` name, as
    ``model.param_shardings`` lays them on ``mesh``.  ``params`` is the
    reference's parameter tree (nested dicts of arrays) or the port's
    full ``state_dict``; a leaf whose dims do not divide stays whole on
    every rank (the divisibility fallback), never padded."""
    from repro_torch.models import model as M

    full = params
    if any(isinstance(v, Mapping) for v in params.values()):
        full = lm_state_dict(params)
    specs = M.param_specs(cfg, mesh)
    if set(full) != set(specs):
        raise ValueError(f"parameter names differ from {cfg.name}'s: "
                         f"{sorted(set(full) ^ set(specs))[:8]}")
    return {k: specs[k].shard(torch.as_tensor(np.asarray(v))
                              if not isinstance(v, torch.Tensor) else v)
            for k, v in full.items()}


def gather_state_dict(local: Mapping, cfg, mesh) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from this rank's blocks (every rank calls
    it and gets the whole)."""
    from repro_torch.models import model as M

    specs = M.param_specs(cfg, mesh)
    return {k: specs[k].gather(v) for k, v in local.items()}


def _leaves(tree: Mapping):
    for sub in tree.values():
        if isinstance(sub, Mapping):
            yield from _leaves(sub)
        else:
            yield sub
