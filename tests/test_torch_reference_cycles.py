"""A model trained, checkpointed, resumed, validated and served by the port
is freed by reference counting alone, with the cyclic collector disabled:
a weak reference to one of its parameters dies when the last user object
goes. Before, three cycles held the weights until a collection: a
self-recursive closure in ``utils/serialization.py``'s tree walks (the
closure's cell held the dict of parameters and slots it had collected),
the circuit breaker's bound-method callback to its ``ContinuousBatcher``
(batcher -> breaker -> batcher, holding the predictor and the model), and
``ServeFuture.result``'s frame holding the future whose stored error's
traceback held that frame.
A small ResNet (depth 8, CIFAR-10 layout) on the CPU stands for the
flagship: the same ``Graph`` of ``CAddTable`` blocks.
"""

import gc
import weakref

import numpy as np
import pytest

from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import ClassNLLCriterion, FlattenTable
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Loss, Top1Accuracy, Trigger
from bigdl_tpu_torch.serving import ModelServer
from bigdl_tpu_torch.utils.serialization import tree_items, unflatten_to_like

SHAPE = (3, 32, 32)


@pytest.fixture
def no_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _model():
    m = ResNet(8, 10, dataset="cifar10", device="cpu")
    m.init(sample_input=np.zeros((2,) + SHAPE, np.float32))
    return m


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + SHAPE).astype(np.float32), rng.integers(0, 10, n)


def _optimizer(model, path, iters):
    x, y = _data()
    o = LocalOptimizer(model, DataSet.array(x, y, batch_size=4), ClassNLLCriterion())
    o.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    o.set_end_when(Trigger.max_iteration(iters))
    o.set_checkpoint(str(path), Trigger.several_iteration(1))
    o.set_validation(Trigger.every_epoch(), DataSet.array(x, y, batch_size=4),
                     [Top1Accuracy(), Loss(ClassNLLCriterion())])
    return o


def test_trained_checkpointed_and_resumed_model_needs_no_collector(no_collector, tmp_path):
    def run():
        first = _model()
        _optimizer(first, tmp_path, 2).optimize()
        resumed = _model()
        _optimizer(resumed, tmp_path, 3).resume(str(tmp_path)).optimize()
        return weakref.ref(next(first.parameters())), weakref.ref(next(resumed.parameters()))

    refs = run()
    assert [r() for r in refs] == [None, None]


def test_served_and_hot_swapped_model_needs_no_collector(no_collector):
    def run():
        first, second = _model(), _model()
        server = ModelServer(supervisor=False)
        server.register("m", first, sample_input=np.zeros(SHAPE, np.float32), batch_size=2,
                        max_delay_ms=1.0)
        x, _ = _data(3)
        assert tuple(server.predict("m", x, timeout=60).shape) == (3, 10)
        server.update("m", second)
        assert tuple(server.predict("m", x, timeout=60).shape) == (3, 10)
        server.close()
        return weakref.ref(next(first.parameters())), weakref.ref(next(second.parameters()))

    refs = run()
    assert [r() for r in refs] == [None, None]


def test_served_model_whose_request_missed_its_deadline_needs_no_collector(no_collector):
    """A future's stored error, once raised by ``result()``, holds that
    frame in its traceback; the frame must not hold the future back
    (``concurrent.futures``' rule). The caller drops the future it caught
    the error from, as ``chip_smoke.py`` [12] does."""
    from bigdl_tpu_torch.serving import DeadlineExceeded

    def run():
        model = _model()
        with ModelServer(supervisor=False) as server:
            server.register("m", model, sample_input=np.zeros(SHAPE, np.float32),
                            batch_size=2, max_delay_ms=200.0)
            late = server.infer("m", np.zeros(SHAPE, np.float32), deadline_ms=1.0)
            with pytest.raises(DeadlineExceeded):
                late.result(timeout=60)
            del late
        return weakref.ref(next(model.parameters()))

    assert run()() is None


def test_tree_walks_and_flatten_table_leave_no_cycle(no_collector):
    class Leaf:
        pass

    def run():
        leaf = Leaf()
        tree = {"a": {"b": leaf, "c": [Leaf(), (Leaf(), None)]}}
        flat = tree_items(tree)
        assert list(flat) == ["a/b", "a/c/0", "a/c/1/0"]
        assert unflatten_to_like(flat, tree)["a"]["b"] is leaf
        return weakref.ref(leaf)

    assert run()() is None
    import torch

    def flatten():
        t = torch.zeros(2)
        out = FlattenTable(device="cpu").apply({}, {}, [t, [torch.ones(1)]])[0]
        assert len(out) == 2
        return weakref.ref(t)

    assert flatten()() is None


_FRESH_PROCESS = r"""
import gc, sys, tempfile, weakref
from pathlib import Path

sys.path[:0] = [sys.argv[1], str(Path(sys.argv[1]).parent)]
import torch
import test_torch_reference_cycles as t
from bigdl_tpu_torch import nn

gc.disable()
assert "torch._dynamo" not in sys.modules, "the check needs a process that has not imported it"


def trained():
    m = t._model()
    with tempfile.TemporaryDirectory() as d:
        t._optimizer(m, Path(d), 1).optimize()  # validate=True: ShapeProp's first meta dispatch
    return weakref.ref(next(m.parameters()))


def checkpointed():
    m = nn.Remat(nn.Linear(4, 4, device="cpu"), device="cpu")
    m.init(sample_input=torch.ones(2, 4))
    y, _ = m.apply(m.get_parameters(), m.get_state(), torch.ones(2, 4), training=True)
    y.sum().backward()  # checkpoint's first call
    return weakref.ref(next(m.parameters()))


print([r() is None for r in (trained(), checkpointed())])
"""


def test_first_meta_dispatch_and_checkpoint_of_a_process_keep_no_model():
    """The first meta dispatch of a process (ShapeProp in ``optimize()``) and
    the first ``torch.utils.checkpoint`` call (``nn.Remat``) import
    ``torch._dynamo``; that import leaves a frame referring to itself, and
    through ``f_back`` every frame below it, to the cyclic collector. Done
    inside the caller's stack, it kept the model. Run in a fresh process:
    in this one another test may have imported ``torch._dynamo`` already,
    which is why the trained-model case above passed in a whole run and
    failed with its file alone."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _FRESH_PROCESS, str(Path(__file__).parent)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[True, True]", out.stdout[-2000:]
