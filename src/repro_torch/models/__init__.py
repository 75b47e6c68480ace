"""The LM substrate of the port: the dense family (Gemma-2B and its
kin) and the moe family (mixtral-8x22b; deepseek-v3-671b with MLA), its
attention running through the port's flash attention kernel on the
card."""
from repro_torch.models import attention, layers, model, moe
from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       SSMConfig)

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "model",
           "layers", "attention", "moe"]
