"""The synthetic token pipeline.  Port of the reference's
``repro.data``."""
from repro_torch.data.tokens import SyntheticTokens, batch_specs

__all__ = ["SyntheticTokens", "batch_specs"]
