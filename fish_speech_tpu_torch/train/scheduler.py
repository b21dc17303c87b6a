"""Learning-rate schedules, as plain functions of the optimizer's step
count that return the learning rate.

Counterpart of `fish_speech_tpu/train/scheduler.py` (ref
fish_speech/scheduler.py:4-40). With an optimizer whose groups start at
lr 1.0, `torch.optim.lr_scheduler.LambdaLR(opt, schedule)` sets each
step's rate to `schedule(step)`; the rate at step 0 is 0, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_schedule(base_lr: float, num_warmup_steps: int,
                           num_training_steps: int, num_cycles: float = 0.5,
                           final_lr_ratio: float = 0.0
                           ) -> Callable[[int], float]:
    """Linear warm-up from 0, then a cosine decay to final_lr_ratio."""
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = ((step - num_warmup_steps)
                    / max(1, num_training_steps - num_warmup_steps))
        progress = min(max(progress, 0.0), 1.0)
        cosine = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * max(final_lr_ratio, cosine)

    return schedule


def constant_warmup_schedule(base_lr: float, num_warmup_steps: int
                             ) -> Callable[[int], float]:
    """Linear warm-up from 0, then base_lr."""
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        return base_lr

    return schedule
