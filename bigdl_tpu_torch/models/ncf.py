"""Neural Collaborative Filtering, NeuMF (counterpart of
``bigdl_tpu/models/ncf.py``; the model of the BigDL paper's NCF benchmark).

Input: (B, 2) integer [user id, item id], both 1-based
(``LookupTable(one_based_input=True)``). The MLP tower concatenates the
user's and item's embeddings (``mlp_user_embed``, ``mlp_item_embed``)
through ``mlp_tower`` (``mlp_fc{i}`` + ``mlp_relu{i}``); with
``include_mf`` the GMF tower multiplies separate embeddings
(``mf_user_embed``, ``mf_item_embed``) elementwise and its product is
concatenated BEFORE the MLP's last hidden layer; ``fuse_out`` maps the
fusion to ``class_num`` logits, then log-softmax (the reference trains it
as a classifier with ClassNLL, which keeps HitRatio/NDCG usable on its
scores). The children carry the JAX package's names, so parameter paths
coincide. Every module is created on ``device``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import nn


class NeuralCF(nn.Container):
    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10), include_mf: bool = True,
                 mf_embed: int = 20, device=None):
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = list(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        d = {"device": device}
        mlp_user = nn.LookupTable(user_count, user_embed, one_based_input=True,
                                  **d).set_name("mlp_user_embed")
        mlp_item = nn.LookupTable(item_count, item_embed, one_based_input=True,
                                  **d).set_name("mlp_item_embed")
        mlp = nn.Sequential(**d).set_name("mlp_tower")
        width = user_embed + item_embed
        for i, h in enumerate(self.hidden_layers):
            mlp.add(nn.Linear(width, h, **d).set_name(f"mlp_fc{i}"))
            mlp.add(nn.ReLU(**d).set_name(f"mlp_relu{i}"))
            width = h
        children = [mlp_user, mlp_item, mlp]
        fuse_dim = width
        if include_mf:
            mf_user = nn.LookupTable(user_count, mf_embed, one_based_input=True,
                                     **d).set_name("mf_user_embed")
            mf_item = nn.LookupTable(item_count, mf_embed, one_based_input=True,
                                     **d).set_name("mf_item_embed")
            children += [mf_user, mf_item]
            fuse_dim += mf_embed
        children.append(nn.Linear(fuse_dim, class_num, **d).set_name("fuse_out"))
        super().__init__(*children, device=device)

    def _children(self):
        by_name = {m.name(): m for m in self._layers}
        return by_name, [by_name[k] for k in ("mlp_user_embed", "mlp_item_embed", "mlp_tower",
                                              "fuse_out")]

    def build(self, generator: torch.Generator, sample) -> None:
        """Build each child from the part of ``sample`` it sees."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            self._forward({}, {}, sample, False, None, generator)
        self._built = True

    def _forward(self, params, state, x, training, rng, generator=None):
        """The forward over ``params``; with a ``generator`` each child is
        built from its input first and runs on its own parameters."""
        by_name, (mlp_user, mlp_item, mlp, out) = self._children()
        new_state = {}

        def child(m, v):
            if generator is not None:
                return self._build_child(m, generator, v)
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], v,
                                                     training, rng)
            return y

        idx = torch.as_tensor(x).to(torch.int32)
        user, item = idx[:, 0:1], idx[:, 1:2]
        ue, ie = child(mlp_user, user), child(mlp_item, item)
        hidden = child(mlp, torch.cat([ue.reshape(ue.shape[0], -1),
                                       ie.reshape(ie.shape[0], -1)], dim=-1))
        if self.include_mf:
            mu, mi = child(by_name["mf_user_embed"], user), child(by_name["mf_item_embed"], item)
            gmf = mu.reshape(mu.shape[0], -1) * mi.reshape(mi.shape[0], -1)
            hidden = torch.cat([gmf, hidden], dim=-1)
        logits = child(out, hidden)
        return torch.log_softmax(logits, dim=-1), new_state

    def _apply_params(self, params, state, x, training, rng):
        return self._forward(params, state, x, training, rng)
