"""The input-shape grid of the dry run and each cell's input specs.  Port
of the reference's ``repro.launch.shapes``.

Every (arch x shape) pair, 40 cells, is defined here, the documented
skips included (long_500k for the archs of full quadratic attention, per
the assignment; recorded as status "skip: ..." with the reason).  The
specs are meta tensors: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data.tokens import batch_specs
from repro_torch.device import torch_dtype
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """None if runnable, else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skip: full quadratic attention at 524288-token decode "
                "(assignment: run long-context only for SSM/hybrid/SWA)")
    if shape.kind == "decode" and not cfg.has_decoder:
        return "skip: encoder-only architecture has no decode step"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, compute_dtype=None
                ) -> dict:
    """Meta-tensor stand-ins for every model input of this cell: the
    train batch (``data.tokens.batch_specs``), the prefill's tokens and
    stub front-end input, or the decode step's token, position and
    seq_len-deep cache (``model.cache_abstract``)."""
    cd = torch_dtype(compute_dtype or cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, B, S, cd)}
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), torch.int32)}
        if cfg.family == "encdec":
            out["enc_frames"] = _meta((B, cfg.enc_seq, cfg.d_model), cd)
        if cfg.family == "vlm":
            out["extra_embeds"] = _meta((B, cfg.vis_seq, cfg.d_model), cd)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _meta((B, 1), torch.int32),
            "positions": _meta((B, 1), torch.int32),
            "cache": M.cache_abstract(cfg, B, S, cd)}
