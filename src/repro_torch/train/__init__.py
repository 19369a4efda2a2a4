"""Training runtime (port of ``repro.train``): dependency-free AdamW +
schedules (incl. minicpm's WSD), the grad-accumulation step factory,
atomic digest-verified checkpointing in the reference's format, and
preemption / straggler / elastic fault tolerance."""

from repro_torch.train import checkpoint, fault_tolerance, optimizer, train_loop
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update, lr_at
from repro_torch.train.train_loop import TrainConfig, make_train_step, train

__all__ = [
    "checkpoint",
    "fault_tolerance",
    "optimizer",
    "train_loop",
    "OptConfig",
    "adamw_init",
    "adamw_update",
    "lr_at",
    "TrainConfig",
    "make_train_step",
    "train",
]
