"""Single-device training (counterpart of ``bigdl_tpu/optim/local_optimizer.py``'s
``Optimizer`` facade and ``LocalOptimizer``).

``LocalOptimizer(model, dataset, criterion).set_optim_method(...)
.set_end_when(...).optimize()`` runs the JAX package's drive loop on the
module's device, one eager step per batch:

1. the model is built from the first training batch if it is not yet;
2. each epoch, ``dataset.shuffle(epoch)`` and one pass over its batches;
3. each iteration: ``lr = method.get_learning_rate()``, a train-mode
   forward through ``model.apply``, the criterion, ``loss.backward()``
   (torch autograd; the flash attention's gradient is the dQ and dK/dV
   kernels, the max pool's the max-pool backward kernel), ``method.update``
   in place, the gradients dropped, and the forward's new state (BN running
   statistics, which carry no autograd history) kept on the model;
4. the loss is read on the host one step late, after the next step has
   been dispatched, so the host never waits on the step it just queued;
5. ``neval`` and ``epoch`` advance in the method's state table and
   ``end_when`` is checked after every iteration and every epoch.

Each iteration is logged (loss, learning rate, records/s) and kept in
``history``. Validation, checkpoints, micro-batches, the flat update, the
ragged-batch pad-and-mask seam, gradient clipping, telemetry, health and
resilience wait for a later slice of the port; the constructor's keyword
arguments for them raise ``NotImplementedError`` when not at their defaults.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.random import RandomGenerator
from .optim_method import SGD, OptimMethod
from .trigger import Trigger

log = logging.getLogger(__name__)

# the JAX package's Optimizer keyword arguments and their defaults
_UNPORTED = {"validate": True, "donate": True, "flat_update": False, "comms_dtype": None,
             "error_feedback": True, "master_dtype": None, "slot_dtype": None}


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``; from pinned memory without blocking when
    that is the card (a pageable copy would wait for the queued step)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class LocalOptimizer:
    """Trains ``model`` on ``dataset`` against ``criterion`` on the model's
    device (see the module docstring)."""

    def __init__(self, model, dataset, criterion, **kwargs):
        for key, val in kwargs.items():
            if key not in _UNPORTED:
                raise TypeError(f"LocalOptimizer got an unexpected keyword argument {key!r}")
            if val != _UNPORTED[key]:
                raise NotImplementedError(
                    f"LocalOptimizer({key}={val!r}) is not ported yet "
                    f"(only the default {_UNPORTED[key]!r})")
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.history: List[Dict[str, Any]] = []

    def set_optim_method(self, method: OptimMethod) -> "LocalOptimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "LocalOptimizer":
        self.end_when = trigger
        return self

    def _first_batch_input(self):
        first = next(iter(self.dataset.data(train=True)), None)
        if first is None:
            raise ValueError(
                f"dataset yields no full training batch: size={self.dataset.size()} "
                "is smaller than the batch size (ragged train batches are dropped)")
        return first.get_input()

    def optimize(self):
        """Run until ``end_when`` fires; returns the trained model."""
        model, method = self.model, self.optim_method
        state = method.state
        if not model.is_built():
            model.build(RandomGenerator.generator(),
                        model._as_input(self._first_batch_input()))
        device = model.device
        params = model.get_parameters()
        slots = method.init_slots(params)
        model.zero_grad(set_to_none=True)
        t_start = time.perf_counter()
        mark: Dict[str, Optional[float]] = {"t": None}  # host time of the last loss pull

        def flush(rec) -> None:
            neval, epoch, loss, n, lr = rec
            loss_f = float(loss)  # one step late: the next step is queued already
            now = time.perf_counter()
            wall = now - mark["t"]
            mark["t"] = now
            throughput = n / max(wall, 1e-9)
            state["loss"] = loss_f
            self.history.append({"neval": neval, "epoch": epoch, "loss": loss_f, "lr": lr,
                                 "records": n, "wall_s": wall,
                                 "records_per_sec": throughput})
            log.info("[Epoch %d][Iteration %d][Wall %.3fs] loss is %.6f, lr %.6g, "
                     "throughput is %.1f records/s", epoch, neval, now - t_start,
                     loss_f, lr, throughput)

        pending = None
        stop = False
        while not stop:
            self.dataset.shuffle(state["epoch"])
            for batch in self.dataset.data(train=True):
                lr = method.get_learning_rate()
                if mark["t"] is None:
                    mark["t"] = time.perf_counter()
                x = _to_device(batch.get_input(), device)
                t = _to_device(batch.get_target(), device)
                y, new_state = model.apply(params, model.get_state(), x, training=True,
                                           rng=RandomGenerator.generator())
                loss = self.criterion._apply(y, t)
                loss.backward()
                method.update(model.get_grad_parameters(), params, slots, lr, state["neval"])
                model.zero_grad(set_to_none=True)
                model.set_state(new_state)
                prev, pending = pending, (state["neval"], state["epoch"], loss.detach(),
                                          batch.size(), lr)
                if prev is not None:
                    flush(prev)
                state["learningrate"] = lr
                state["neval"] += 1
                if self.end_when(state):
                    stop = True
                    break
            if pending is not None:
                flush(pending)
                pending = None
            if not stop:
                state["epoch"] += 1
                state["_epoch_done"] = True
                if self.end_when(state):
                    stop = True
                state["_epoch_done"] = False
        return model
