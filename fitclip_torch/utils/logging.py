"""Metric logging: console + JSONL (port of ``fitclip_tpu/utils/logging.py``;
its TensorBoard and pluggable sinks, which no caller of the port uses, are
left out)."""

import json
import logging
import os
import time
from typing import Mapping, Optional

LOGGER = logging.getLogger("fitclip_torch")


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        entry = {"step": int(step), "time": time.time(), **scalars}
        if self._jsonl:
            self._jsonl.write(json.dumps(entry) + "\n")
            self._jsonl.flush()
        LOGGER.info("step %d: %s", step, " ".join(f"{k}={v:.5g}" for k, v in scalars.items()))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
