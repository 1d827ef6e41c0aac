"""The port's TF-graph op modules (``bigdl_tpu_torch/nn/ops.py``) against
the JAX package's (``bigdl_tpu/nn/ops.py``), op by op on inputs drawn from
a seed with numpy.

Each case runs the same inputs through the JAX op (64-bit types off, as
the package runs) and the port's op on the CPU and holds the results to the
same values and the same dtype: exactly for integer, boolean and
selection results, within 1e-6 (+1e-6 relative) for float arithmetic. The
cases include ties (``ArgMax``/``ArgMin``/``TopKOp`` take the lower index),
TF ``SAME`` padding at odd sizes (the odd pad at the end; ``MaxPool``'s pad
is -inf on all-negative inputs, ``AvgPool`` divides by the valid count),
the 64-bit narrowing (``Cast``/``Const``/``Variable`` and integer
reductions), the floor ``Mod`` and truncating ``TruncatedDivide`` on
negative operands, and the control-flow ops (``Switch``, a clipped
``Merge``, ``Variable``/``Assign`` state).
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn.ops as J
import bigdl_tpu_torch.nn.ops as P
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch.utils.table import T as PT

D = {"device": "cpu"}
RNG = np.random.default_rng


def _f(*shape, seed=0, scale=1.0):
    return (RNG(seed).standard_normal(shape) * scale).astype(np.float32)


def _i(*shape, seed=0, lo=-5, hi=6):
    return RNG(seed).integers(lo, hi, shape).astype(np.int32)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _as_inputs(args, table):
    """numpy args -> (JAX input, port input): one tensor or a Table."""
    import jax.numpy as jnp

    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    pa = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args]
    if table:
        return JT(*ja), PT(*pa)
    return ja[0], pa[0]


def check(jop, pop, *args, table=None, exact=False, atol=1e-6, rtol=1e-6):
    """Forward ``args`` through both ops; results (a tensor or a tuple)
    equal in value and dtype. Returns the port's result."""
    table = len(args) > 1 if table is None else table
    jx, px = _as_inputs(args, table)
    jy = jop.forward(jx)
    py = pop.forward(px)
    jys = jy if isinstance(jy, tuple) else (jy,)
    pys = py if isinstance(py, tuple) else (py,)
    assert len(jys) == len(pys)
    for a, b in zip(jys, pys):
        a, b = np.asarray(a), _np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        assert a.shape == b.shape, (a.shape, b.shape)
        if exact or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, equal_nan=True)
    return py


def both(name, *a, **k):
    return getattr(J, name)(*a, **k), getattr(P, name)(*a, **k, **D)


# ----------------------------------------------------------- const / shape
@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.int64).reshape(2, 3) - 3,     # int64 -> int32
    np.float64([1.5, -2.25, 3e-40]),                    # float64 -> float32
    np.bool_([True, False]),
    np.float32(2.5),
    np.uint8([0, 255]),
], ids=["int64", "float64", "bool", "scalar", "uint8"])
def test_const_narrows_as_jax(value):
    check(*both("Const", value), _f(2, 2), exact=True)


def test_variable_and_assign_state():
    j, p = both("Variable", np.float64([1.0, 2.0, -3.0]))
    check(j, p, np.zeros((), np.float32), exact=True)
    assert p.get_parameters()["value"].dtype == torch.float32
    ja, pa = both("Assign")
    check(ja, pa, np.float32([0.0]), np.float32([5.0, 6.0]), exact=True)
    np.testing.assert_array_equal(_np(pa.get_state()["value"]),
                                  np.asarray(ja.get_state()["value"]))


@pytest.mark.parametrize("name", ["Shape", "Rank", "SizeOp"])
def test_shape_rank_size(name):
    check(*both(name), _f(2, 3, 4))


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32, np.float32, np.bool_,
                                   np.uint8, np.int8])
def test_cast(dtype):
    x = np.float32([1.9, -1.9, 0.0, 2.5, -0.5, 7.0, np.nan, 3e9, -3e9, 300.0, -300.0])
    check(*both("Cast", dtype), x, exact=True)
    check(*both("Cast", dtype), _i(6, seed=3), exact=True)
    check(*both("Cast", dtype), np.bool_([True, False]), exact=True)


@pytest.mark.parametrize("value", [np.float32(7.0), np.int32(3), np.float64(1.25)])
def test_fill(value):
    check(*both("Fill"), np.int32([2, 3]), value, exact=True)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_expand_dims(axis):
    check(*both("ExpandDims", axis), _f(2, 3), exact=True)


def test_tile_and_pad():
    check(*both("Tile", (2, 1, 3)), _f(2, 3, 1), exact=True)
    check(*both("Pad", [(1, 2), (0, 1)], 0.5), _f(2, 3), exact=True)
    check(*both("Pad", [(0, 0), (2, 0), (1, 1)]), _i(2, 2, 3), exact=True)


@pytest.mark.parametrize("begin,size", [((1, 1), (2, 2)), ((2, 3), (2, 2)),
                                        ((-1, 0), (1, 4)), ((0, 9), (3, 1))])
def test_slice_clamps_as_dynamic_slice(begin, size):
    check(*both("SliceOp", begin, size), np.arange(12, dtype=np.int32).reshape(3, 4))


def test_one_hot_with_out_of_range_indices():
    check(*both("OneHot", 4), np.int32([0, 2, 5, -1, 3]))
    check(*both("OneHot", 3, 2.0, -1.0), np.float32([[0, 1], [2, 7]]))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather(axis):
    x = _f(3, 4, 5, seed=2)
    idx = np.int32([[2, 0], [1, 1]])
    check(*both("GatherOp", axis), x, idx, exact=True)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)])
def test_matmul(ta, tb):
    a = _f(*((4, 3) if ta else (3, 4)), seed=4)
    b = _f(*((5, 4) if tb else (4, 5)), seed=5)
    check(*both("MatMul", ta, tb), a, b, atol=1e-5, rtol=1e-5)


def test_bias_add_and_l2loss():
    check(*both("BiasAdd"), _f(2, 3, 4), _f(4, seed=1))
    check(*both("L2Loss"), _f(5, 6, seed=2), atol=1e-5, rtol=1e-6)
    check(*both("L2Loss"), _i(4, 3, seed=3))


# ------------------------------------------------------------ comparisons
BINARY = ["Equal", "NotEqual", "Greater", "GreaterEqual", "Less", "LessEqual", "Maximum",
          "Minimum", "SquaredDifference", "TruncatedDivide", "Mod"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_float(name):
    a = np.float32([-7.5, -3.0, -1.0, 0.0, 2.5, 3.0, 7.0, np.nan, 4.0])
    b = np.float32([2.0, -2.0, 3.0, 1.5, -1.0, 3.0, -4.0, 1.0, 4.0])
    check(*both(name), a, b)


@pytest.mark.parametrize("name", BINARY)
def test_binary_int(name):
    a = np.int32([-7, -3, -1, 0, 2, 3, 7, 5])
    b = np.int32([2, -2, 3, 1, -1, 3, -4, 5])
    check(*both(name), a, b)


@pytest.mark.parametrize("name", ["LogicalAnd", "LogicalOr"])
def test_logical(name):
    a = np.bool_([1, 1, 0, 0])
    b = np.bool_([1, 0, 1, 0])
    check(*both(name), a, b)
    check(*both("LogicalNot"), a)


def test_select():
    check(*both("SelectOp"), np.bool_([1, 0, 1]), np.float32([1, 2, 3]),
          np.float32([9, 8, 7]), exact=True)
    check(*both("SelectOp"), np.int32([0, 4, 0]), _i(3, seed=1), _i(3, seed=2))


# -------------------------------------------------------------- reductions
REDUCTIONS = ["ReduceSum", "ReduceMean", "ReduceProd", "ReduceMax", "ReduceMin", "All", "Any"]
AXES = [None, (0,), (1,), (0, 2), (-1,), ()]


@pytest.mark.parametrize("name", REDUCTIONS)
@pytest.mark.parametrize("axis", AXES, ids=[str(a) for a in AXES])
@pytest.mark.parametrize("keep", [False, True])
def test_reductions(name, axis, keep):
    for x in (_f(2, 3, 4, seed=6), _i(2, 3, 4, seed=7, lo=-3, hi=4),
              _i(2, 3, 4, seed=8, lo=0, hi=2).astype(np.bool_)):
        check(*both(name, axis, keep), x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["ArgMax", "ArgMin"])
@pytest.mark.parametrize("axis", [0, 1])
def test_arg_ties_take_the_lower_index(name, axis):
    x = np.float32([[1, 9, 9, 2], [9, 0, 3, 9], [9, 9, 0, 0]])
    check(*both(name, axis), x)
    check(*both(name, axis), -x)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_top_k_ties(k):
    x = np.float32([[3, 1, 3, 2, 3], [0, 0, 0, 0, 0], [5, -1, 5, np.inf, -np.inf]])
    check(*both("TopKOp", k), x)
    check(*both("TopKOp", k), _i(3, 5, seed=9, lo=0, hi=3))


# ------------------------------------------------------- elementwise unary
UNARY = ["Rsqrt", "Erf", "Inv", "Round", "Floor", "Ceil", "Expm1", "IsFinite", "IsInf",
         "IsNan", "Sign"]


@pytest.mark.parametrize("name", UNARY)
def test_unary(name):
    x = np.float32([0.5, 1.5, 2.5, -0.5, -2.5, 3.7, -3.7, 0.0, np.inf, -np.inf, np.nan, 4.0])
    if name == "Rsqrt":
        x = np.abs(x)
    check(*both(name), x, atol=1e-6, rtol=2e-6)


# ------------------------------------------------------------ control flow
@pytest.mark.parametrize("pred", [True, False])
def test_switch(pred):
    check(*both("Switch"), _f(2, 3), np.bool_(pred), exact=True)


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 7, -4])
def test_merge_clips_its_one_based_index(idx):
    check(*both("Merge"), np.int32(idx), _f(2, 2, seed=1), _f(2, 2, seed=2), _f(2, 2, seed=3),
          exact=True)


# ------------------------------------------------- TF-graph conv/pool ops
CONVS = [
    # (input NHWC, filter HWIO, strides, padding, dilations)
    ((2, 7, 9, 3), (3, 3, 3, 4), (1, 1, 1, 1), "SAME", None),
    ((2, 7, 9, 3), (3, 3, 3, 4), (1, 2, 2, 1), "SAME", None),
    ((1, 8, 6, 2), (4, 4, 2, 3), (1, 3, 2, 1), "SAME", None),
    ((1, 8, 6, 2), (2, 3, 2, 3), (1, 1, 1, 1), "VALID", None),
    ((1, 9, 9, 2), (3, 3, 2, 2), (1, 1, 1, 1), "SAME", (1, 2, 2, 1)),
    ((1, 10, 11, 2), (3, 2, 2, 2), (1, 2, 1, 1), "VALID", (1, 1, 3, 1)),
]


@pytest.mark.parametrize("shape,w,strides,padding,dil", CONVS,
                         ids=[f"{c[3]}-{c[2][1]}{c[2][2]}-{i}" for i, c in enumerate(CONVS)])
def test_conv2d(shape, w, strides, padding, dil):
    check(*both("Conv2D", strides, padding, "NHWC", dil), _f(*shape, seed=1),
          _f(*w, seed=2), atol=1e-5, rtol=1e-5)


POOLS = [((2, 5, 7, 3), (1, 3, 3, 1), (1, 2, 2, 1), "SAME"),
         ((1, 6, 6, 2), (1, 2, 2, 1), (1, 2, 2, 1), "SAME"),
         ((1, 7, 5, 2), (1, 2, 3, 1), (1, 1, 2, 1), "SAME"),
         ((2, 7, 7, 2), (1, 3, 3, 1), (1, 2, 2, 1), "VALID"),
         ((1, 4, 9, 1), (1, 4, 4, 1), (1, 3, 3, 1), "SAME")]


@pytest.mark.parametrize("name", ["MaxPool", "AvgPool"])
@pytest.mark.parametrize("shape,k,s,padding", POOLS,
                         ids=[f"{p[3]}-{i}" for i, p in enumerate(POOLS)])
def test_pools(name, shape, k, s, padding):
    x = _f(*shape, seed=3)
    check(*both(name, k, s, padding), x)
    check(*both(name, k, s, padding), -np.abs(x) - 1.0)  # -inf pad vs 0 pad shows here


def test_nchw_is_refused():
    with pytest.raises(ValueError, match="NHWC"):
        P.Conv2D((1, 1, 1, 1), "SAME", "NCHW", **D)
    with pytest.raises(ValueError, match="NHWC"):
        P.MaxPool((1, 2, 2, 1), (1, 2, 2, 1), "SAME", "NCHW", **D)


def test_reshape_transpose_squeeze_concat():
    check(*both("ReshapeOp", (-1, 6)), _f(2, 3, 2), exact=True)
    check(*both("TransposeOp", (0, 3, 1, 2)), _f(2, 3, 4, 5), exact=True)
    check(*both("Squeeze", (1, 3)), _f(2, 1, 3, 1), exact=True)
    check(*both("Squeeze"), _f(1, 2, 1, 3), exact=True)
    check(*both("ConcatOp", 1), _f(2, 3), _f(2, 1, seed=1), _f(2, 2, seed=2), exact=True)


@pytest.mark.parametrize("op", ["Mean", "Sum", "Max", "Min"])
@pytest.mark.parametrize("axes,keep", [((1, 2), False), ((2,), True), ((), False)])
def test_reduce_op(op, axes, keep):
    check(*both("ReduceOp", op, axes, keep), _f(2, 3, 4, seed=5), atol=1e-5, rtol=1e-5)
    if op != "Mean":
        check(*both("ReduceOp", op, axes, keep), _i(2, 3, 4, seed=6))


@pytest.mark.parametrize("fmt,shape", [("NHWC", (2, 4, 4, 3)), ("NCHW", (2, 3, 4, 4))])
def test_fused_batch_norm(fmt, shape):
    c = 3
    var = RNG(4).uniform(0.5, 2.0, c).astype(np.float32)
    check(*both("FusedBatchNorm", 1e-3, fmt), _f(*shape), _f(c, seed=1), _f(c, seed=2),
          _f(c, seed=3), var, atol=1e-5, rtol=1e-5)


def test_every_op_class_is_ported_and_graph_wirable():
    import inspect

    names = [n for n, c in vars(J).items() if inspect.isclass(c) and c.__module__ == J.__name__
             and not n.startswith("_")]
    assert len(names) >= 60
    for n in names:
        pc = getattr(P, n)
        assert pc.accepts_table_input is True
        assert getattr(pc, "graph_source", False) == (n in ("Const", "Variable"))


def test_const_lives_on_its_device_and_follows_to():
    c = P.Const(np.float32([1, 2]), device="meta")
    assert c.value.device.type == "meta"
    c = P.Const(np.float32([1, 2]), device="cpu").to(torch.float64)
    assert c.value.dtype == torch.float64
