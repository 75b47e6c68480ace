"""Distributed substrate: logical-axis sharding rules and gradient
compression.  Port of the reference's ``repro.dist``; the meshes and
their collectives are ``repro_torch.launch.mesh``'s, and
``grblas/dist.py`` (the distributed SpMM) stays in ``repro_torch.grblas``."""
from repro_torch.dist.sharding import (AxisRules, DEFAULT_RULES, DP_RULES,
                                       active_rules, constrain,
                                       logical_to_mesh, named_sharding,
                                       resolve_spec, rules_for,
                                       set_active_rules, use_rules)
from repro_torch.dist.compression import (compressed_psum_tree,
                                          dequantize_int8,
                                          init_error_feedback, quantize_int8)

__all__ = [
    "AxisRules", "DEFAULT_RULES", "DP_RULES", "active_rules", "constrain",
    "logical_to_mesh", "named_sharding", "resolve_spec", "rules_for",
    "set_active_rules", "use_rules",
    "compressed_psum_tree", "dequantize_int8", "init_error_feedback",
    "quantize_int8",
]
