"""Text models (counterpart of ``bigdl_tpu/models/textclassifier.py``),
under the JAX package's layer names, so parameter paths coincide; every
module is created on ``device``:

* ``BiLSTMClassifier`` (BASELINE config 4): LookupTable ->
  BiRecurrent(LSTM) -> the last step -> Linear -> LogSoftMax;
* ``CNNTextClassifier`` (reference: ``$DL/example/textclassification``):
  LookupTable -> TemporalConvolution -> ReLU -> TemporalMaxPooling ->
  TemporalConvolution -> ReLU -> Max over time -> Linear -> LogSoftMax;
* ``PTBModel`` (reference: ``$DL/models/rnn/PTBModel.scala``): LookupTable
  -> ``num_layers`` stacked Recurrent(LSTM) -> TimeDistributed(Linear) ->
  LogSoftMax over (N, T, vocab).

Their ids are 0-based (``LookupTable``'s default), as in the JAX package.
"""

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


def CNNTextClassifier(vocab_size: int, embedding_dim: int = 128, class_num: int = 20,
                      kernel_w: int = 5, pool_w: int = 5, device=None) -> nn.Sequential:
    d = {"device": device}
    return nn.Sequential(
        nn.LookupTable(vocab_size, embedding_dim, **d).set_name("embedding"),
        nn.TemporalConvolution(embedding_dim, 128, kernel_w, **d).set_name("conv1"),
        nn.ReLU(**d).set_name("relu1"),
        nn.TemporalMaxPooling(pool_w, pool_w, **d).set_name("pool1"),
        nn.TemporalConvolution(128, 128, kernel_w, **d).set_name("conv2"),
        nn.ReLU(**d).set_name("relu2"),
        nn.Max(1, n_input_dims=2, **d).set_name("global_max"),  # max over time
        nn.Linear(128, class_num, **d).set_name("fc"),
        nn.LogSoftMax(**d).set_name("logsoftmax"),
        **d,
    )


def PTBModel(vocab_size: int = 10000, embedding_dim: int = 200, hidden_size: int = 200,
             num_layers: int = 2, device=None) -> nn.Sequential:
    d = {"device": device}
    m = nn.Sequential(nn.LookupTable(vocab_size, embedding_dim, **d).set_name("embedding"),
                      **d)
    width = embedding_dim
    for i in range(num_layers):
        m.add(nn.Recurrent(nn.LSTM(width, hidden_size, **d).set_name(f"lstm{i}"), **d)
              .set_name(f"rec{i}"))
        width = hidden_size
    m.add(nn.TimeDistributed(nn.Linear(hidden_size, vocab_size, **d).set_name("decoder"), **d)
          .set_name("td_decoder"))
    m.add(nn.LogSoftMax(**d).set_name("logsoftmax"))
    return m
