"""The parallel runtime of the port: one process a rank over
``torch.distributed``. Data parallelism (``DistriOptimizer``, the ZeRO-1 flat
layout ``FlatParameter``, the compressed gradient exchange), hybrid data x
tensor parallelism over sharding plans (``HybridParallelOptimizer``,
``ShardingPlan``), ring-attention sequence parallelism (``ring_attention``),
GPipe pipeline parallelism (``pipeline_apply``, ``pipeline_apply_hetero``,
``PipelineOptimizer``) and switch-MoE expert parallelism (``moe_ffn``,
``ExpertParallelOptimizer``): the JAX package's dp/tp/pp/sp/ep axis set, each
``shard_map`` there a set of explicit collectives over a mesh axis here
(:mod:`._comm`, :class:`.sharding.Mesh`)."""

from .moe import moe_capacity, moe_ffn, moe_ffn_reference
from .parameter import FlatParameter
from .pipeline import pipeline_apply, pipeline_apply_hetero, stack_stage_params
from .sequence import ring_attention, ring_attention_shard
from .sharding import (Mesh, P, ShardingPlan, megatron_transformer_plan,
                       megatron_transformer_rules, replicated_plan)

_LAZY = {
    # the optimizers import nn, whose MoE and attention layers import this
    # package: they load on first use
    "DistriOptimizer": "distri_optimizer", "simulate_step": "distri_optimizer",
    "HybridParallelOptimizer": "hybrid", "ParallelCompositionError": "hybrid",
    "make_mesh": "hybrid", "PipelineOptimizer": "pipeline_optimizer",
    "ExpertParallelOptimizer": "pipeline_optimizer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DistriOptimizer",
    "ExpertParallelOptimizer",
    "FlatParameter",
    "HybridParallelOptimizer",
    "ParallelCompositionError",
    "PipelineOptimizer",
    "ShardingPlan",
    "make_mesh",
    "megatron_transformer_plan",
    "megatron_transformer_rules",
    "moe_ffn",
    "moe_ffn_reference",
    "pipeline_apply",
    "pipeline_apply_hetero",
    "replicated_plan",
    "stack_stage_params",
    "ring_attention",
    "ring_attention_shard",
    "Mesh",
    "P",
    "moe_capacity",
    "simulate_step",
]
