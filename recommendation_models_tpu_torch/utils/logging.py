"""Structured metrics (SURVEY.md §5 'Metrics / logging / observability').

Per-sweep records (loss, RMSE, rows/sec/chip, collective bytes) go to JSONL
and optionally to TensorBoard when tensorboardX is importable; without it,
``MetricsLogger`` warns and writes the JSONL alone. Python ``logging``
elsewhere, under the logger ``recommendation_models_tpu_torch``. The same
records as the JAX package's ``utils/logging.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("recommendation_models_tpu_torch")


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                logger.warning("tensorboardX unavailable; TB logging disabled")

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": step, "ts": time.time(), **metrics}
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


__all__ = ["MetricsLogger", "logger"]
