"""Metric logging: console, JSONL and pluggable sinks (port of
``fitclip_tpu/utils/logging.py``).

The JSONL stream (``<log_dir>/metrics.jsonl``) is the durable record. An
experiment tracker plugs in as a sink: any object with ``log(metrics, step)``
and, optionally, ``close()``, which the train command instantiates from
``trainer.logger={_target_: my.module.MySink, ...}`` (the reference's
NeptuneLogger slot, drift_eval_trainer.yaml:25-27). The JAX logger also
writes TensorBoard events when TensorFlow imports; the port writes none.
"""

import json
import logging
import os
import time
from typing import Any, Mapping, Optional, Sequence

LOGGER = logging.getLogger("fitclip_torch")


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 sinks: Optional[Sequence[Any]] = None) -> None:
        self.log_dir = log_dir
        self.sinks = list(sinks or [])
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
        for sink in self.sinks:
            sink.log(scalars, step)
        LOGGER.info("step %d: %s", step, " ".join(f"{k}={v:.5g}" for k, v in scalars.items()))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close:
                close()
