"""The LM substrate of the port: the dense family (Gemma-2B and its
kin), the moe family (mixtral-8x22b; deepseek-v3-671b with MLA), the
ssm family (mamba2-780m) and the hybrid family (jamba-1.5-large-398b),
its attention running through the port's flash attention kernel on
the card."""
from repro_torch.models import attention, layers, mamba2, model, moe
from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       SSMConfig)

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "model",
           "layers", "attention", "moe", "mamba2"]
