"""TrainSummary / ValidationSummary (counterpart of
``bigdl_tpu/visualization/summary.py``; the reference's
``$DL/visualization/Summary.scala``, ``TrainSummary.scala`` and
``ValidationSummary.scala``).

``TrainSummary(log_dir, app_name)`` takes the scalars ``Loss``,
``LearningRate`` and ``Throughput`` every iteration and parameter
histograms when its ``"Parameters"`` trigger fires; ``ValidationSummary``
one scalar per validation method. Files land in
``<log_dir>/<app_name>/{train,validation}`` and render in stock
TensorBoard. A histogram takes a tensor on any device (one host copy, at
the trigger only).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tb import (
    EventWriter,
    encode_event,
    encode_histogram_summary,
    encode_scalar_summary,
    read_events,
)


def _host(values) -> np.ndarray:
    if hasattr(values, "detach"):  # a tensor, on any device
        values = values.detach().float().cpu().numpy()
    return np.asarray(values)


class Summary:
    def __init__(self, log_dir: str, app_name: str, sub_dir: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.dir = os.path.join(log_dir, app_name, sub_dir)
        self.writer = EventWriter(self.dir)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.write_event(
            encode_event(time.time(), step=step, summary=encode_scalar_summary(tag, value))
        )
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.write_event(
            encode_event(
                time.time(),
                step=step,
                summary=encode_histogram_summary(tag, _host(values)),
            )
        )
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """[(step, value)] for a tag (reference: ``readScalar``)."""
        self.writer.flush()
        out = []
        for ev in read_events(self.dir):
            if tag in ev["scalars"]:
                out.append((ev["step"], ev["scalars"][tag]))
        return out

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        # tag -> trigger; "Parameters" histograms default OFF (expensive), the
        # scalar tags default every iteration — reference defaults.
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        self._triggers[name] = trigger
        return self

    def trigger_for(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")
