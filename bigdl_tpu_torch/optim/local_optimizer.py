"""Single-device training (counterpart of ``bigdl_tpu/optim/local_optimizer.py``'s
``Optimizer`` facade, ``LocalOptimizer`` and module-level ``validate``).

``LocalOptimizer(model, dataset, criterion).set_optim_method(...)
.set_end_when(...).optimize()`` runs the JAX package's drive loop on the
module's device, one eager step per batch:

1. the model is built from the first training batch if it is not yet;
2. each epoch, ``dataset.shuffle(epoch)`` and one pass over its batches
   (after ``resume``, the batches of the checkpoint's epoch that were
   already trained are skipped: ``_iter_in_epoch``);
3. each iteration: ``lr = method.get_learning_rate()``, a train-mode
   forward through ``model.apply``, the criterion, ``loss.backward()``
   (torch autograd; the flash attention's gradient is the dQ and dK/dV
   kernels, the max pool's the max-pool backward kernel), the gradients
   clipped (``set_constant_gradient_clipping`` first, then
   ``set_gradient_clipping_by_l2_norm``: one fp32 norm over all leaves),
   ``method.update`` in place, the gradients dropped, and the forward's new
   state (BN running statistics, which carry no autograd history) kept on
   the model. With ``set_micro_batches(n)`` the batch is split into n row
   slices: their gradients are summed and divided by n (the full batch's
   mean), and one update applied; the model state is carried from slice to
   slice, so BN running statistics advance n times a step (ghost batch
   norm, as the JAX package's scan);
4. the loss is read on the host one step late, after the next step has
   been dispatched, so the host never waits on the step it just queued;
5. ``neval``, ``_iter_in_epoch`` and ``epoch`` advance in the method's
   state table; after every iteration and at every epoch end come, in the
   JAX package's order, the validation (``set_validation``: it writes
   ``score``, the first method's result, and counts ``n_validations``), the
   checkpoint (``set_checkpoint``, see :mod:`bigdl_tpu_torch.utils.serialization`)
   and the ``end_when`` check.

The ragged-batch seam: the dataset's first training batch fixes the step's
rows. A shorter train batch (from a dataset that yields its epoch tail;
``LocalArrayDataSet`` drops it) is padded back to them by repeating row 0
and its pad rows masked out of the loss exactly (``criterion.unreduced``),
when the criterion has that row-wise form, no BatchNormalization couples
the rows of the forward and no ``SparseTensor`` is in the batch (its
entries are not rows); otherwise it is dropped, as the reference does.
Only a padded batch takes the masked form of the loss: on a full batch it
equals the criterion's own (the JAX package masks every step so that one
compiled step serves both; an eager step has no such reason).

``resume(path)`` restores the newest verified checkpoint (the JAX package's
or the port's): parameters, BN state and optimizer slots are copied into
the existing tensors on the model's device, the state table and the RNG
position are restored, and the next ``optimize()`` continues the run.

Each iteration is logged (loss, learning rate, records/s) and kept in
``history``. The flat update and its precision policies, buffer donation
and the construction-time audit are not ported (their keyword arguments
raise ``NotImplementedError`` when not at their defaults); nor are
summaries, telemetry, health, retry, preemption and elastic training.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..dataset.dataset import pad_minibatch, to_device
from ..nn.normalization import BatchNormalization
from ..utils.random import RandomGenerator
from ..utils.serialization import (copy_into, latest_checkpoint_step, load_checkpoint,
                                   save_checkpoint, tree_items, unflatten_to_like)
from .optim_method import SGD, OptimMethod
from .predictor import forward_padded
from .trigger import Trigger
from .validation import ValidationMethod, ValidationResult

log = logging.getLogger(__name__)

# the JAX package's Optimizer keyword arguments and their defaults
_UNPORTED = {"validate": True, "donate": True, "flat_update": False, "comms_dtype": None,
             "error_feedback": True, "master_dtype": None, "slot_dtype": None}


def validate(model, params, model_state, dataset, methods) -> Dict[str, ValidationResult]:
    """One eval-mode sweep of ``methods`` over ``dataset`` with ``params``
    and ``model_state``, their results merged with ``+``: the first batch
    fixes the rows, a shorter one is padded to them on the device
    (``forward_padded``; one holding a ``SparseTensor`` runs at its own
    rows) and its output sliced back before the metrics,
    whose targets stay unpadded. One host transfer a batch: its numerators
    together."""
    totals: Dict[str, ValidationResult] = {}
    rows: Optional[int] = None
    device = model.device
    for batch in dataset.data(train=False):
        if rows is None:
            rows = batch.size()
        with torch.inference_mode():
            y = forward_padded(model, params, model_state, to_device(batch.get_input(), device),
                               rows)
            t = to_device(batch.get_target(), device)
            pairs = [m.metric(y, t) for m in methods]
            nums = torch.stack([num.reshape(()).to(torch.float64) for num, _ in pairs])
        for m, num, (_, cnt) in zip(methods, nums.tolist(), pairs):
            r = m.make_result(num, int(cnt))
            totals[m.name] = totals[m.name] + r if m.name in totals else r
    return totals


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
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: Optional[List[ValidationMethod]] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_keep_last: Optional[int] = None
        self._grad_clip_norm: Optional[float] = None
        self._grad_clip_const: Optional[tuple] = None
        self._micro_batches = 1
        self._mask_ragged = False  # resolved on the built model in optimize()
        self._step_rows: Optional[int] = None  # rows of the dataset's first training batch
        self._warned_ragged_drop = False
        self._restored_slots: Optional[Dict[str, Any]] = None
        self._resume_skip_iters = 0
        self.history: List[Dict[str, Any]] = []

    # ----------------------------------------------------------- configuration
    def set_optim_method(self, method: OptimMethod) -> "LocalOptimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "LocalOptimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod]) -> "LocalOptimizer":
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        return self

    def set_checkpoint(self, path: Optional[str] = None, trigger: Optional[Trigger] = None,
                       keep_last: Optional[int] = None) -> "LocalOptimizer":
        """Checkpoint into ``path`` whenever ``trigger`` fires; ``keep_last=N``
        prunes all but the N newest after each save (None keeps all)."""
        if trigger is None:
            raise ValueError("set_checkpoint needs a trigger")
        if path is None:
            raise ValueError("set_checkpoint() needs a path (the port has no run directory "
                             "to default under)")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.checkpoint_keep_last = keep_last
        return self

    def set_micro_batches(self, n: int) -> "LocalOptimizer":
        """Split each batch into ``n`` row slices, one update a batch (see the
        module docstring; BN statistics become slice-local)."""
        if n < 1:
            raise ValueError(f"micro batch count must be >= 1, got {n}")
        self._micro_batches = int(n)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float) -> "LocalOptimizer":
        self._grad_clip_norm = float(clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float) -> "LocalOptimizer":
        self._grad_clip_const = (float(min_v), float(max_v))
        return self

    # ---------------------------------------------------------------- resume
    def resume(self, checkpoint_path: Optional[str] = None) -> "LocalOptimizer":
        """Restore params, BN state, slots, the state table, the RNG position
        and the data position from the newest verified checkpoint, so that
        the next :meth:`optimize` continues the run; builds the model from
        the first training batch first when needed."""
        if checkpoint_path is not None:
            self.checkpoint_path = checkpoint_path
        if self.checkpoint_path is None:
            raise ValueError("resume() needs a checkpoint path (set_checkpoint or argument)")
        if latest_checkpoint_step(self.checkpoint_path) is None:
            raise FileNotFoundError(f"resume(): no checkpoints under {self.checkpoint_path}")
        if not self.model.is_built():
            self.model.build(RandomGenerator.generator(),
                             self.model._as_input(self._first_batch().get_input()))
        self._resume_from_checkpoint()
        return self

    def _resume_from_checkpoint(self) -> int:
        """Restore from the newest verified checkpoint; returns its step."""
        params, flat_slots, host, flat_model_state = load_checkpoint(self.checkpoint_path)
        self._commit_restored(params, flat_model_state, flat_slots,
                              {k: v for k, v in host.items() if not k.startswith("_rng")},
                              (host["_rng_seed"], host["_rng_counter"]),
                              host.get("_iter_in_epoch", 0))
        return int(host.get("neval", 0))

    def _commit_restored(self, flat_params, flat_model_state, flat_slots, host_items, rng,
                         skip_iters) -> None:
        """Copy params and model state into the model's tensors in place
        (``Predictor`` and the optimizer hold references to them); keep the
        slots for ``optimize()``'s fresh ones; restore the state table, the
        RNG position and the mid-epoch data position."""
        copy_into(self.model.get_parameters(), flat_params, "parameter")
        copy_into(self.model.get_state(), flat_model_state, "model state")
        self._restored_slots = flat_slots
        state = self.optim_method.state
        for k, v in host_items.items():
            state[k] = v
        RandomGenerator.restore(rng[0], rng[1])
        self._resume_skip_iters = int(skip_iters)

    def _init_slots(self, method: OptimMethod, params):
        """Fresh slots, or the checkpointed ones copied into them."""
        slots = method.init_slots(params)
        if self._restored_slots is not None:
            copy_into(slots, self._restored_slots, "optimizer slot")
            self._restored_slots = None
        return slots

    # ----------------------------------------------------------- checkpoints
    def _maybe_checkpoint(self, state, slots) -> None:
        if self.checkpoint_path is None or self.checkpoint_trigger is None:
            return
        if self.checkpoint_trigger(state):
            self._write_checkpoint(state, slots)

    def _write_checkpoint(self, state, slots) -> Dict[str, Any]:
        """One verified checkpoint at the current step (``neval``)."""
        return save_checkpoint(self.checkpoint_path, step=state["neval"],
                               params=self.model.get_parameters(), optim_slots=slots,
                               optim_state=dict(state), model_state=self.model.get_state(),
                               keep_last=self.checkpoint_keep_last)

    # ------------------------------------------------------------ validation
    def _run_validation(self) -> Optional[Dict[str, ValidationResult]]:
        state = self.optim_method.state
        if (self.validation_trigger is None or self.validation_dataset is None
                or not self.validation_trigger(state)):
            return None
        results = validate(self.model, self.model.get_parameters(), self.model.get_state(),
                           self.validation_dataset, self.validation_methods)
        for name, res in results.items():
            v, n = res.result()
            log.info("%s is %.6f (n=%d)", name, v, n)
        # score feeds max_score triggers
        state["score"] = next(iter(results.values())).result()[0]
        state["n_validations"] = state.get("n_validations", 0) + 1
        return results

    # ------------------------------------------------------------- the step
    def _has_batch_coupled_state(self) -> bool:
        """True when the training forward couples rows across the batch
        outside the criterion (BatchNormalization's batch statistics): pad
        rows would reach them even with the loss masked."""
        return any(isinstance(m, BatchNormalization) for m in self.model.modules())

    def _masked_loss(self, y, t, nvalid: float) -> torch.Tensor:
        """The criterion's loss over the first ``nvalid`` rows of a padded
        batch, the pad rows masked out exactly (``criterion.unreduced``)."""
        pair = self.criterion.unreduced(y, t)
        if pair is None:
            raise TypeError(f"{type(self.criterion).__name__}.unreduced() returned None although "
                            "supports_unreduced() claimed a row-wise form")
        per, denom = pair
        b = y.shape[0]
        row = (torch.arange(b, device=per.device) < nvalid).to(per.dtype)
        if per.dim() == 1 and per.shape[0] != b and per.shape[0] % b == 0:
            mask = row.repeat_interleave(per.shape[0] // b)  # (batch*positions,) rows
        else:
            mask = row.reshape((b,) + (1,) * (per.dim() - 1))
        num = torch.sum(per * mask)
        if getattr(self.criterion, "size_average", True):
            return num / torch.clamp(torch.sum(denom * mask), min=1e-8)
        return num

    def _loss(self, model_state, x, t, rng, nvalid: Optional[float]):
        """The training forward's loss (masked past ``nvalid`` real rows when
        given) and new model state."""
        y, new_state = self.model.apply(self.model.get_parameters(), model_state, x,
                                        training=True, rng=rng)
        if nvalid is not None:
            return self._masked_loss(y, t, nvalid), new_state
        return self.criterion._apply(y, t), new_state

    def _micro_step(self, x, t, rng, nvalid: Optional[float]):
        """Gradients (set as ``.grad``) summed over the row slices and divided
        by their count (on a padded batch: weighted by each slice's real rows
        and divided by their sum), the model state carried from slice to
        slice; returns ``(loss, new_state)``."""
        n = self._micro_batches
        if not isinstance(x, torch.Tensor):
            raise NotImplementedError("set_micro_batches on Table inputs is not ported")
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch size {b} not divisible by micro batch count {n}")
        mb = b // n
        params = list(tree_items(self.model.get_parameters()).values())
        ms = self.model.get_state()
        g_acc, losses, l_sum, v_sum = None, [], 0.0, 0.0
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            v = None if nvalid is None else float(min(max(nvalid - i * mb, 0.0), mb))
            loss_m, ms = self._loss(ms, x[rows], t[rows], rng, v)
            g = torch.autograd.grad(loss_m, params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, g)]
            if nvalid is not None:
                g = [gi * v for gi in g]
                l_sum, v_sum = l_sum + loss_m.detach() * v, v_sum + v
            else:
                losses.append(loss_m.detach())
            g_acc = g if g_acc is None else [a + gi for a, gi in zip(g_acc, g)]
        if nvalid is not None:
            v_sum = max(v_sum, 1.0)
            grads, loss = [g / v_sum for g in g_acc], l_sum / v_sum
        else:
            grads, loss = [g / n for g in g_acc], torch.stack(losses).mean()
        for p, g in zip(params, grads):
            p.grad = g
        return loss, ms

    def _clip_grads(self, grads):
        if self._grad_clip_const is None and self._grad_clip_norm is None:
            return grads
        flat = tree_items(grads)
        leaves = list(flat.values())
        if self._grad_clip_const is not None:
            lo, hi = self._grad_clip_const
            leaves = [torch.clamp(g, lo, hi) for g in leaves]
        if self._grad_clip_norm is not None:
            total = 0.0
            for g in leaves:
                total = total + torch.sum(g.float() * g.float())
            scale = torch.clamp(self._grad_clip_norm / (torch.sqrt(total) + 1e-12), max=1.0)
            leaves = [g * scale for g in leaves]
        return unflatten_to_like(dict(zip(flat, leaves)), grads)

    def _train_step(self, x, t, nvalid: Optional[float], lr: float, params,
                    slots) -> torch.Tensor:
        """Forward, loss, backward, clipping and the update in place (the
        loss masked past ``nvalid`` real rows of a padded batch); returns the
        loss on the device."""
        model = self.model
        rng = RandomGenerator.generator()
        if self._micro_batches == 1:
            loss, new_state = self._loss(model.get_state(), x, t, rng, nvalid)
            loss.backward()
        else:
            loss, new_state = self._micro_step(x, t, rng, nvalid)
        grads = self._clip_grads(model.get_grad_parameters())
        self.optim_method.update(grads, params, slots, lr, self.optim_method.state["neval"])
        model.zero_grad(set_to_none=True)
        model.set_state(new_state)
        return loss.detach()

    def _ragged_seam(self, batch):
        """``(batch, real rows)``, the batch padded to the step's rows when it
        is short and can be masked, or None to drop it."""
        n = batch.size()
        if n < self._step_rows:
            padded = pad_minibatch(batch, self._step_rows) if self._mask_ragged else None
            if padded is None:
                if not self._warned_ragged_drop:
                    self._warned_ragged_drop = True
                    log.warning("dropping ragged %d-row batch (step shape is %d rows and it "
                                "cannot be pad-masked: criterion without a per-sample "
                                "decomposition, BatchNorm in the model, or non-dense leaves)",
                                n, self._step_rows)
                return None
            return padded
        return batch, n

    def _first_batch(self):
        """The dataset's first training batch: it builds the model and fixes
        the step's rows (also when a resume skips it)."""
        first = next(iter(self.dataset.data(train=True)), None)
        if first is None:
            raise ValueError(
                f"dataset yields no full training batch: size={self.dataset.size()} "
                "is smaller than the batch size (ragged train batches are dropped)")
        return first

    # ----------------------------------------------------------- the loop
    def optimize(self):
        """Run until ``end_when`` fires; returns the trained model."""
        model, method = self.model, self.optim_method
        state = method.state
        first = self._first_batch()
        self._step_rows = first.size()
        if not model.is_built():
            model.build(RandomGenerator.generator(), model._as_input(first.get_input()))
        self._mask_ragged = (self.criterion.supports_unreduced()
                             and not self._has_batch_coupled_state())
        device = model.device
        params = model.get_parameters()
        slots = self._init_slots(method, params)
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
            self.dataset.shuffle(state["epoch"])  # the epoch's order, also on resume
            state["_epoch_done"] = False
            batches = self.dataset.data(train=True)
            skip = self._resume_skip_iters
            if skip:  # resumed mid-epoch: skip the batches already trained
                self._resume_skip_iters = 0
                batches = itertools.islice(batches, skip, None)
            state["_iter_in_epoch"] = skip
            for batch in batches:
                seam = self._ragged_seam(batch)
                if seam is None:
                    continue
                batch, n = seam
                lr = method.get_learning_rate()
                if mark["t"] is None:
                    mark["t"] = time.perf_counter()
                loss = self._train_step(to_device(batch.get_input(), device),
                                        to_device(batch.get_target(), device),
                                        float(n) if n < batch.size() else None, lr,
                                        params, slots)
                prev, pending = pending, (state["neval"], state["epoch"], loss, n, lr)
                if prev is not None:
                    flush(prev)
                state["learningrate"] = lr
                state["neval"] += 1
                state["_iter_in_epoch"] += 1
                self._run_validation()
                self._maybe_checkpoint(state, slots)
                if self.end_when(state):
                    stop = True
                    break
            if pending is not None:
                flush(pending)
                pending = None
            if not stop:
                state["_iter_in_epoch"] = 0
                state["epoch"] += 1
                state["_epoch_done"] = True
                self._run_validation()
                self._maybe_checkpoint(state, slots)
                if self.end_when(state):
                    stop = True
                state["_epoch_done"] = False
        return model
