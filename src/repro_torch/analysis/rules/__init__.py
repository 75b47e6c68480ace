"""Rule modules register themselves on import (same pattern as the
backend/solver registries: one module per rule family, one
``register_rule`` call per invariant)."""
from repro_torch.analysis.rules import (  # noqa: F401
    boundary,
    dtypes,
    hostsync,
    padsound,
    purity,
    registries,
    retrace,
)
