"""The BiLSTM text classifier (counterpart of ``BiLSTMClassifier`` in
``bigdl_tpu/models/textclassifier.py``; BASELINE config 4): LookupTable ->
BiRecurrent(LSTM) -> the last step -> Linear -> LogSoftMax, under the JAX
package's layer names, so parameter paths coincide. Every module is
created on ``device``. ``CNNTextClassifier`` and ``PTBModel`` wait for a
later slice."""

from __future__ import annotations

from .. import nn


def BiLSTMClassifier(vocab_size: int, embedding_dim: int = 128, hidden_size: int = 128,
                     class_num: int = 20, merge_mode: str = "concat",
                     device=None) -> nn.Sequential:
    d = {"device": device}
    out_width = 2 * hidden_size if merge_mode == "concat" else hidden_size
    return nn.Sequential(
        nn.LookupTable(vocab_size, embedding_dim, **d).set_name("embedding"),
        nn.BiRecurrent(nn.LSTM(embedding_dim, hidden_size, **d), merge_mode=merge_mode, **d)
        .set_name("bilstm"),
        nn.Select(2, -1, **d).set_name("last_step"),
        nn.Linear(out_width, class_num, **d).set_name("fc"),
        nn.LogSoftMax(**d).set_name("logsoftmax"),
        **d,
    )
