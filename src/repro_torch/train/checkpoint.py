"""Atomic checkpointing.  Port of the reference's
``repro.train.checkpoint``, with its layout:

  <dir>/step_<N>/
     manifest.json      step, time, extra, and each leaf's file, shape
                        and dtype, keyed by the leaf's path
     <leaf-path>.npy    one file a leaf (a host array)

Atomicity: written into ``step_<N>.tmp`` then ``os.rename``d, so a
crashed save never shadows a good checkpoint; ``latest()`` ignores tmp
dirs.  ``keep`` checkpoints are kept, the oldest removed.

A tree is a nest of dicts, lists, tuples and NamedTuples whose leaves
are tensors or ``nn.Module``s (the model's parameter tree).  A leaf's
path joins the keys, indices and field names with "/"; a module's
tensors are leaves keyed by their ``state_dict`` names below it (so the
launcher's ``(params, opt_state)`` holds ``0/blocks.0.attn.wq`` and
``1/mu/blocks.0.attn.wq``).  numpy has no bfloat16: a bf16 tensor is
stored as its uint16 bits, with "bfloat16" as its dtype in the manifest,
and restored bit for bit.  ``restore(step, like)`` returns a tree
shaped like ``like``: its tensors new, in ``like``'s dtypes and on its
devices; a module of ``like`` is loaded in place and returned.

Elasticity, as the reference's: leaves are stored as full logical
arrays.  Under a mesh every rank calls ``save(..., shardings=)`` (a tree
shaped like ``tree`` whose leaves are ``NamedSharding``s; a module's
entry a dict of them by ``state_dict`` name, ``model.param_specs``):
each leaf is gathered from the ranks' blocks, rank 0 writes, the
manifest records the mesh's shape, and the ranks wait for the write.
``restore(..., shardings=)`` slices each rank's block out of the full
arrays, so a run resumes on a mesh of another shape (or on none).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from repro_torch.launch.mesh import is_distributed_initialized


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in order."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, nn.Module):
        for k, t in tree.state_dict().items():
            yield join(k), t
    elif isinstance(tree, dict):
        for k, sub in tree.items():
            yield from _leaves(sub, join(k))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), join(k))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, join(i))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        raise TypeError(f"{path}: a {type(tree).__name__} is not a "
                        "checkpoint leaf")


def _rebuild(tree, load, path: str = ""):
    """``tree``'s structure with each tensor leaf replaced by
    ``load(path, like)`` and each module loaded in place."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for k, t in tree.state_dict().items():
                t.copy_(load(join(k), t))
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(sub, load, join(k)) for k, sub in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, k), load, join(k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, load, join(i))
                          for i, sub in enumerate(tree))
    return load(path, tree)


def _shardings(tree, path: str = ""):
    """{leaf path: NamedSharding} of a tree of NamedShardings (a dict, a
    list, a tuple or a NamedTuple of them)."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {p: s for k, sub in tree.items()
                for p, s in _shardings(sub, join(k)).items()}
    if _is_namedtuple(tree):
        return {p: s for k in tree._fields
                for p, s in _shardings(getattr(tree, k), join(k)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, sub in enumerate(tree)
                for p, s in _shardings(sub, join(i)).items()}
    return {path: tree}


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             shardings: Any = None):
        """Write ``tree`` as step ``step``.  Under a mesh (``shardings``)
        every rank calls it: the leaves are gathered, rank 0 writes."""
        specs = _shardings(shardings)
        mesh = next(iter(specs.values())).mesh if specs else None
        writer = mesh is None or mesh.rank == 0
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

        manifest = {"step": step, "time": time.time(),
                    "extra": extra or {}, "leaves": {}}
        if mesh is not None:
            manifest["mesh"] = dict(mesh.shape)
        for name, leaf in _leaves(tree):
            if name in specs:
                leaf = specs[name].gather(leaf)
            if not writer:
                continue
            arr, dtype = _to_host(leaf)
            fn = name.replace("/", "__") + ".npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype}
        if writer:
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f, indent=1)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                   # atomic publish
            self._gc()
        if mesh is not None and is_distributed_initialized():
            tdist.barrier()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self):
        out = []
        for d in self.dir.iterdir():
            if d.is_dir() and d.name.startswith("step_") \
                    and not d.name.endswith(".tmp"):
                try:
                    out.append(int(d.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, shardings: Any = None
                ) -> Tuple[Any, dict]:
        """(a tree shaped like ``like`` holding step ``step``'s leaves,
        the saved ``extra``).  With ``shardings`` (as ``save`` takes
        them, for the mesh of this run) each leaf is this rank's block
        of the saved full array: the elastic re-shard."""
        d = self.dir / f"step_{step}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        specs = _shardings(shardings)

        def load(name, leaf):
            info = manifest["leaves"][name]
            t = _from_host(np.load(d / info["file"]), info["dtype"])
            if name in specs:
                t = specs[name].shard(t)
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return _rebuild(like, load), manifest["extra"]

    def restore_latest(self, like: Any, shardings: Any = None
                       ) -> Tuple[Optional[int], Any, dict]:
        s = self.latest()
        if s is None:
            return None, like, {}
        tree, extra = self.restore(s, like, shardings)
        return s, tree, extra
