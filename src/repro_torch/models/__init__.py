"""The LM substrate of the port: the dense family (Gemma-2B and its
kin), its GQA attention running through the port's flash attention
kernel on the card."""
from repro_torch.models import attention, layers, model
from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       SSMConfig)

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "model",
           "layers", "attention"]
