from .scheduler import constant_warmup_schedule, cosine_warmup_schedule
from .step import (
    Optimizer,
    TrainBatch,
    dual_ar_grads,
    dual_ar_loss,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "Optimizer", "TrainBatch", "dual_ar_grads", "dual_ar_loss",
    "make_optimizer", "make_train_step", "cosine_warmup_schedule",
    "constant_warmup_schedule",
]
