"""Training: optimizers, the train step, checkpointing and fault
tolerance.  Port of the reference's ``repro.train``."""
from repro_torch.train.optimizer import (adamw, adafactor, get_optimizer,
                                         Optimizer)
from repro_torch.train.loop import (TrainConfig, make_train_step,
                                    lr_schedule, make_optimizer,
                                    init_compression_state)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (
    PreemptionGuard, StepWatchdog, run_with_restarts)

__all__ = ["adamw", "adafactor", "get_optimizer", "Optimizer",
           "TrainConfig", "make_train_step", "lr_schedule", "make_optimizer",
           "init_compression_state",
           "CheckpointManager", "PreemptionGuard", "StepWatchdog",
           "run_with_restarts"]
