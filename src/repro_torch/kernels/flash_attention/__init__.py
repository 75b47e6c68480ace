from repro_torch.kernels.flash_attention.flash_attention import (
    LAUNCHES,
    build,
    flash_attention_cuda,
    kernel_variant,
    reset_launch_counts,
    start_build,
)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     plain_attention)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)

__all__ = ["LAUNCHES", "build", "start_build", "reset_launch_counts",
           "flash_attention", "flash_attention_cuda", "kernel_variant",
           "plain_attention", "attention_ref", "attention_ref_chunked"]
