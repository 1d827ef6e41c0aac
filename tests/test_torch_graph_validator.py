"""The port's ``GraphValidator`` against the JAX package's: each wiring of
``tests/test_analysis.py::TestFailFast`` (a cycle, a merge-arity fault,
duplicate names, a dangling node) and a few more (an orphan root, an
unreachable input, a module at two nodes, table layers at merge points)
built in both packages from the same recipe. The findings' ``(code,
severity)`` lists must be equal; a fatal wiring must stop the port's
``Graph`` with the port's ``GraphValidationError``, naming the same
modules, and ``validate=False`` must construct it.

The dangling node is held in a variable in both packages: the port's nodes
hold their children weakly, so a dangling node that nothing holds is freed
and not reported (the last test).
"""

import gc

import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.analysis import GraphValidationError as JGraphValidationError
from bigdl_tpu.analysis import GraphValidator as JGraphValidator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.analysis import GraphValidationError, GraphValidator


def _cycle(nn, d):
    na = nn.ModuleNode(nn.ReLU(**d).set_name("loop_a"))
    nb = nn.ModuleNode(nn.Tanh(**d).set_name("loop_b"), [na])
    na.parents.append(nb)
    return [nn.Input()], [nb], []


def _merge_arity(nn, d):
    inp = nn.Input()
    a, b = nn.ReLU(**d).inputs(inp), nn.Tanh(**d).inputs(inp)
    return [inp], [nn.Linear(4, 2, **d).set_name("needs_merge").inputs(a, b)], []


def _duplicate_names(nn, d):
    inp = nn.Input()
    a = nn.Linear(4, 4, **d).set_name("twin").inputs(inp)
    return [inp], [nn.Linear(4, 4, **d).set_name("twin").inputs(a)], []


def _dangling(nn, d):
    inp = nn.Input()
    a = nn.ReLU(**d).inputs(inp)
    dead = nn.Tanh(**d).set_name("dead_end").inputs(a)  # wired, feeds no output
    return [inp], [nn.Linear(4, 2, **d).inputs(a)], [dead]


def _orphan_root(nn, d):
    inp = nn.Input()
    orphan = nn.ModuleNode(nn.ReLU(**d).set_name("orphan"))
    return [inp], [nn.CAddTable(**d).inputs(nn.Tanh(**d).inputs(inp), orphan)], []


def _unreachable_input(nn, d):
    inp, extra = nn.Input(), nn.Input()
    return [inp, extra], [nn.ReLU(**d).inputs(inp)], []


def _shared(nn, d):
    a, b = nn.Input(), nn.Input()
    enc = nn.Linear(6, 4, **d).set_name("enc")
    return [a, b], [nn.CAddTable(**d).inputs(enc.inputs(a), enc.inputs(b))], []


def _table_merges(nn, d):
    a, b = nn.Input(), nn.Input()
    ra, rb = nn.ReLU(**d).inputs(a), nn.ReLU(**d).inputs(b)
    outs = [nn.JoinTable(2, **d).inputs(ra, rb), nn.DotProduct(**d).inputs(ra, rb),
            nn.MapTable(nn.Linear(4, 3, **d), **d).inputs(ra, rb),
            nn.CosineDistance(**d).inputs(ra, rb), nn.Sequential(nn.CMulTable(**d), **d)
            .inputs(ra, rb)]
    return [a, b], outs, []


CASES = {"cycle": _cycle, "merge_arity": _merge_arity, "duplicate_names": _duplicate_names,
         "dangling": _dangling, "orphan_root": _orphan_root,
         "unreachable_input": _unreachable_input, "shared": _shared,
         "table_merges": _table_merges}


def _findings(validator, make, nn, d):
    inputs, outputs, keep = make(nn, d)
    found = validator(inputs=inputs, outputs=outputs).findings()
    return inputs, outputs, keep, found


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_jax(case):
    _, _, _, jf = _findings(JGraphValidator, CASES[case], jnn, {})
    inputs, outputs, keep, pf = _findings(GraphValidator, CASES[case], pnn, {"device": "cpu"})
    assert [(f.code, f.severity) for f in pf] == [(f.code, f.severity) for f in jf]
    errors = [f for f in jf if f.severity == "error"]
    if errors:
        with pytest.raises(JGraphValidationError):
            jnn.Graph(*CASES[case](jnn, {})[:2])
        with pytest.raises(GraphValidationError) as ei:
            pnn.Graph(inputs, outputs, device="cpu")
        for f in pf:
            assert f.path in str(ei.value) or f.severity == "warning"
    else:
        g = pnn.Graph(inputs, outputs, device="cpu")
        assert [(f.code, f.severity) for f in GraphValidator(g).findings()] == \
            [(f.code, f.severity) for f in jf]


@pytest.mark.parametrize("case", ["merge_arity", "orphan_root"])
def test_validate_false_constructs(case):
    inputs, outputs, _ = CASES[case](pnn, {"device": "cpu"})
    assert isinstance(pnn.Graph(inputs, outputs, validate=False, device="cpu"), pnn.Graph)


def test_messages_name_the_modules():
    for case, words in (("cycle", ("loop_a", "loop_b")), ("merge_arity", ("needs_merge",
                                                                          "2 parent")),
                        ("duplicate_names", ("twin",))):
        inputs, outputs, _ = CASES[case](pnn, {"device": "cpu"})
        with pytest.raises(GraphValidationError) as ei:
            pnn.Graph(inputs, outputs, device="cpu")
        assert all(w in str(ei.value) for w in words), str(ei.value)


def test_a_dangling_node_nothing_holds_is_freed():
    gc.disable()
    try:
        inp = pnn.Input()
        a = pnn.ReLU(device="cpu").inputs(inp)
        pnn.Tanh(device="cpu").set_name("dead_end").inputs(a)
        g = pnn.Graph(inp, pnn.Linear(4, 2, device="cpu").inputs(a), device="cpu")
        assert GraphValidator(g).findings() == []
        assert a.children == [g.output_nodes[0]]
    finally:
        gc.enable()
