"""``Remat``: gradient checkpointing as a module wrapper (counterpart of
``bigdl_tpu/nn/remat.py``).

The wrapped module's activations are not kept for the backward: it runs
again there (``torch.utils.checkpoint``, non-reentrant), trading operations
for memory. The wrapper changes no number: outputs and gradients are the
unwrapped module's to the bit, its state update is the forward's, applied
once. ``policy`` names what may still be saved, as the JAX package's
``jax.checkpoint_policies`` names do (a selective checkpoint over the aten
ops the forward dispatches):

* ``None``, ``"nothing_saveable"``: nothing, everything recomputed (a
  plain checkpoint);
* ``"everything_saveable"``: every output, so nothing runs again: the
  module runs as it would unwrapped;
* ``"dots_saveable"``, ``"checkpoint_dots"``: the outputs of the products
  and of the convolutions (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, ``convolution``, ``_int_mm``, ``_scaled_mm``), as XLA's
  ``dot_general`` and ``conv_general_dilated``;
* ``"dots_with_no_batch_dims_saveable"``,
  ``"checkpoint_dots_with_no_batch_dims"``: the products without a batch
  dim (``mm``, ``addmm``, ``mv``, ``dot``, a ``bmm`` / ``baddbmm`` over one
  batch), as ``dot_general`` without batch dimensions.

The repo's CUDA kernels are launched from Python, not dispatched as aten
ops, so no policy saves their outputs: they run again in the backward, as
a ``pallas_call`` does under ``jax.checkpoint``.

Random draws: the port's dropout draws from the host generator ``rng``
(:mod:`bigdl_tpu_torch.nn.dropout`), which ``checkpoint``'s
``preserve_rng_state`` does not restore. The wrapper takes the generator's
state before the forward and runs the module on a copy of it, the forward
and the recompute alike, so both draw the same masks; the caller's
generator then moves on exactly as the unwrapped forward would move it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .module import AbstractModule, Container, import_torch_dynamo, infer_module_shape

_POLICIES = (
    "everything_saveable",
    "nothing_saveable",
    "dots_saveable",
    "checkpoint_dots",
    "dots_with_no_batch_dims_saveable",
    "checkpoint_dots_with_no_batch_dims",
)

_aten = torch.ops.aten
_UNBATCHED = (_aten.mm, _aten.addmm, _aten.mv, _aten.dot)
_BATCHED = (_aten.bmm, _aten.baddbmm)
_DOTS = _UNBATCHED + _BATCHED + (_aten.convolution, _aten._int_mm, _aten._scaled_mm)


def _save_if(pred):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if pred(op, args) else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _is_dot(op, args) -> bool:
    return op.overloadpacket in _DOTS


def _is_unbatched_dot(op, args) -> bool:
    packet = op.overloadpacket
    if packet in _UNBATCHED:
        return True
    # a bmm over one batch is a product without a batch dim (einsum's form)
    batch = args[1] if packet is _aten.baddbmm else args[0]
    return packet in _BATCHED and batch.shape[0] == 1


# the selective policies (the others need no per-op choice)
_POLICY_FNS = {
    "dots_saveable": _save_if(_is_dot),
    "checkpoint_dots": _save_if(_is_dot),
    "dots_with_no_batch_dims_saveable": _save_if(_is_unbatched_dot),
    "checkpoint_dots_with_no_batch_dims": _save_if(_is_unbatched_dot),
}


class Remat(Container):
    """Wrap ONE module so its backward recomputes its activations instead
    of keeping them; ``policy`` is one of the names above (a string, so it
    serializes)."""

    def __init__(self, module: AbstractModule, policy: Optional[str] = None, device=None):
        if policy is not None and policy not in _POLICIES:
            raise ValueError(f"unknown checkpoint policy {policy!r}; one of {_POLICIES} "
                             "(argument-taking jax.checkpoint_policies combinators are not "
                             "expressible here)")
        super().__init__(module, device=device)
        self.policy = policy

    def add(self, module: AbstractModule) -> "Remat":
        if getattr(self, "_layers", None):
            raise ValueError("Remat wraps exactly ONE module; wrap a Sequential to checkpoint "
                             "several layers together")
        return super().add(module)

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        if not self._layers[0].is_built():
            self._layers[0].build(generator, sample)
        self._built = True

    def infer_shape(self, in_spec):
        # a schedule change, not a math change: the wrapped module's contract
        return infer_module_shape(self._layers[0], in_spec)

    def _apply_params(self, params, state, x, training, rng):
        child = self._layers[0]
        p, s = params[child.name()], state[child.name()]
        if not torch.is_grad_enabled() or self.policy == "everything_saveable":
            y, ns = child._apply_params(p, s, x, training, rng)
            return y, {child.name(): ns}
        import_torch_dynamo()  # checkpoint's first call imports it: not in this stack
        snapshot = None if rng is None else rng.get_state()
        moved = []  # the generator's state after the first run (not the recompute's)

        def run(xx):
            gen = None
            if snapshot is not None:
                gen = torch.Generator(device=rng.device)
                gen.set_state(snapshot)
            out = child._apply_params(p, s, xx, training, gen)
            if gen is not None and not moved:
                moved.append(gen.get_state())
            return out

        kwargs = {}
        if self.policy in _POLICY_FNS:
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     _POLICY_FNS[self.policy])
        y, ns = checkpoint(run, x, use_reentrant=False, **kwargs)
        if rng is not None:
            rng.set_state(moved[0])
        return y, {child.name(): ns}
