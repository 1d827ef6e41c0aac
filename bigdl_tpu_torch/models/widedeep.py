"""Wide&Deep recommender, BASELINE config 5 (counterpart of
``bigdl_tpu/models/widedeep.py``; reference: the wide&deep example).

Input: ``Table(wide, deep)``, read as ``x[1]`` and ``x[2]``: ``wide`` a
``SparseTensor`` of hashed cross features, ``deep`` an (n, k + numeric)
matrix of k categorical ids (as floats) and numeric columns.

* wide: ``SparseLinear`` over the hashed features (memorisation); like the
  JAX module it computes in the weight's dtype, float32;
* deep: one ``LookupTable`` a categorical column, the embeddings
  concatenated with the numeric columns, then an MLP (generalisation).
  Ids past a table's end clamp to its last row, as in both packages (the
  synthetic log draws all three columns from [0, 100) while the third
  table has 50 rows);
* out: ``log_softmax(wide + deep)``, for ``ClassNLLCriterion``; float32
  under the bf16 policy (a bf16 deep logit plus the f32 wide one).

The children's names are the JAX package's (``wide_linear``,
``deep_embed{i}``, ``deep_mlp/deep_fc{i}``, ``deep_out``), so parameter
paths coincide. Every module is created on ``device``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import nn


class WideAndDeep(nn.Container):
    def __init__(self, class_num: int = 2, wide_dim: int = 5000,
                 embed_vocabs: Sequence[int] = (100, 100, 50), embed_dim: int = 16,
                 numeric_dim: int = 13, hidden: Sequence[int] = (64, 32), device=None):
        d = {"device": device}
        self.class_num = class_num
        self.embed_dim = embed_dim
        self.numeric_dim = numeric_dim
        wide = nn.SparseLinear(wide_dim, class_num, **d).set_name("wide_linear")
        embeds = [nn.LookupTable(v, embed_dim, **d).set_name(f"deep_embed{i}")
                  for i, v in enumerate(embed_vocabs)]
        mlp = nn.Sequential(**d).set_name("deep_mlp")
        width = embed_dim * len(embeds) + numeric_dim
        for i, h in enumerate(hidden):
            mlp.add(nn.Linear(width, h, **d).set_name(f"deep_fc{i}"))
            mlp.add(nn.ReLU(**d).set_name(f"deep_relu{i}"))
            width = h
        mlp.add(nn.Linear(width, class_num, **d).set_name("deep_out"))
        super().__init__(wide, *embeds, mlp, **d)
        self._wide, self._embeds, self._mlp = wide, embeds, mlp

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        wide, deep = sample[1], sample[2]
        self._wide.build(generator, wide)
        n, dev = deep.shape[0], self.device
        for e in self._embeds:
            e.build(generator, torch.zeros((n, 1), dtype=torch.int32, device=dev))
        width = self.embed_dim * len(self._embeds) + self.numeric_dim
        self._mlp.build(generator, torch.zeros((n, width), device=dev))
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        wide_x, deep_x = x[1], x[2]
        new_state = {}

        def child(m, v):
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], v,
                                                     training, rng)
            return y

        k = len(self._embeds)
        cat = deep_x[:, :k].to(torch.int32)
        embedded = [child(e, cat[:, i:i + 1]).reshape(cat.shape[0], -1)
                    for i, e in enumerate(self._embeds)]
        deep = torch.cat(embedded + [deep_x[:, k:].to(torch.float32)], dim=-1)
        wide_logit = child(self._wide, wide_x)
        return torch.log_softmax(wide_logit + child(self._mlp, deep), dim=-1), new_state
