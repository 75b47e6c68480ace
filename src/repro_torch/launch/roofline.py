"""The port's ``repro.launch.hlo_analysis``: a dry-run cell's roofline.

  compute term    = FLOPs / (chips * peak FLOP/s)
  memory term     = HBM bytes / (chips * HBM bandwidth)
  collective term = per-device wire bytes / link bandwidth

The reference reads its FLOPs and bytes from compiled XLA (HLO parsed
by ``hlo_parse``) and its collectives from the partitioned HLO text.
The port has no HLO: ``op_count`` counts the op stream a rank launches
and ``launch.mesh`` records each collective a rank calls, with the wire
bytes of the reference's ring model (``wire_bytes``, the factors of
``hlo_analysis.parse_collectives``).

The constants are one NVIDIA H100 80GB HBM3's at 700 W (its datasheet):
dense bf16 tensor-core peak, HBM3 bandwidth and one NVLink 4 figure, the
bandwidth a direction of a GPU's 18 links together.  An axis of more
than 8 ranks crosses nodes (8 cards to an NVLink domain), where the
link is the network's and far slower; this single figure does not
model that, as the reference's single ``ICI_BW`` does not model its
inter-pod links.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# per card; dense bf16 FLOP/s on the tensor cores:
PEAK_FLOPS_BF16 = 989e12        # NVIDIA H100 80GB HBM3, 700 W (datasheet)
# B/s of HBM3:
HBM_BW = 3.35e12                # NVIDIA H100 80GB HBM3, 700 W (datasheet)
# B/s a direction, NVLink 4 (18 links):
LINK_BW = 450e9                 # NVIDIA H100 80GB HBM3, 700 W (datasheet)


def _kind(kind: str) -> str:
    """The reference's name of a collective kind ("all_gather" and
    "all-gather" alike; "permute" is "collective-permute")."""
    k = kind.replace("_", "-")
    return "collective-permute" if k == "permute" else k


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes one device moves over its link for one collective of
    ``out_bytes`` of output (a reduce-scatter's: the scattered part)
    over ``group`` ranks, under the ring model: all-gather (g-1)/g,
    all-reduce 2(g-1)/g, reduce-scatter g-1, all-to-all (g-1)/g and
    permute 1 times the output (``hlo_analysis.py``'s factors)."""
    k = _kind(kind)
    g = max(int(group), 2)
    f = (g - 1) / g
    if k == "all-gather":
        return out_bytes * f
    if k == "all-reduce":
        return 2.0 * out_bytes * f
    if k == "reduce-scatter":
        return out_bytes * (g - 1)
    if k == "all-to-all":
        return out_bytes * f
    if k == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    """Per-device wire bytes (ring model), by the reference's kind names,
    and the calls of each kind."""

    wire_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, wire: float, calls: int = 1) -> None:
        k = _kind(kind)
        self.wire_bytes += wire
        self.by_kind[k] = self.by_kind.get(k, 0.0) + wire
        self.op_counts[k] = self.op_counts.get(k, 0) + calls


@dataclasses.dataclass
class Roofline:
    """``flops`` and ``hbm_bytes`` over all chips, ``wire_bytes`` per
    device.  ``wire_bytes`` None: the collectives were not traced (a
    static account), and the collective term is None too."""

    flops: float
    hbm_bytes: float
    wire_bytes: Optional[float]
    n_chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        if self.wire_bytes is None:
            return None
        return self.wire_bytes / LINK_BW          # wire bytes are per device

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max((k for k in ts if ts[k] is not None), key=ts.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else float("nan")

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes_per_dev": self.wire_bytes, "n_chips": self.n_chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }
