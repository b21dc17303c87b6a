"""Process-ranked logging and a JSONL metrics sink.

Counterpart of `fish_speech_tpu/utils/logger.py` (ref fish_speech/utils/
logger.py, RankedLogger): log lines prefixed with the process's rank, taken
from torch.distributed when a process group is initialised (0 otherwise),
with rank-zero-only and one-rank emission.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path


def process_rank() -> int:
    """This process's rank in the default torch.distributed group, or 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class RankedLogger(logging.LoggerAdapter):
    def __init__(self, name: str = __name__, rank_zero_only: bool = False,
                 extra=None):
        logger = logging.getLogger(name)
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
        super().__init__(logger, extra or {})
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, rank=None, **kwargs):
        if not self.isEnabledFor(level):
            return
        current = process_rank()
        msg = f"[rank {current}] {msg}"
        if self.rank_zero_only and current != 0:
            return
        if rank is not None and current != rank:
            return
        self.logger.log(level, msg, *args, **kwargs)


class MetricsLogger:
    """Append-only JSONL metrics sink for training runs (stands in for the
    reference's TensorBoard logger, configs/base.yaml:62-68: plot with any
    tool that reads JSONL)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
