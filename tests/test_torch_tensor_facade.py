"""The port's 1-based ``Tensor`` façade (``bigdl_tpu_torch.tensor.Tensor``)
against the JAX package's (``bigdl_tpu.tensor.Tensor``), and ``Shape``.

Every case of ``tests/test_tensor_facade.py`` runs as a scenario through
both packages' façades (the port's on the CPU) and the results must be
equal: shapes, values (float32 to 1e-6 relative: the same reductions
summed in another order; integers, indices and comparisons exactly) and
dtypes by name. Beside them: the result dtypes of the JAX rules the port
follows (64-bit input narrowed, integer sums int32, a 0-dim float32
operand promoting a bfloat16 tensor, a Python scalar keeping it), the
no-aliasing contract (a view's mutation never reaches its parent, nor the
reverse, in both packages), the ``COVERAGE`` tables equal, and ``Shape.of``
/ ``SingleShape`` / ``MultiShape`` against the JAX package's. The random
fills draw from each package's own generator: only their shapes, dtypes
and ranges are compared.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.tensor import Tensor as JTensor
from bigdl_tpu.tensor.tensor import COVERAGE as J_COVERAGE
from bigdl_tpu.utils import MultiShape as JMultiShape
from bigdl_tpu.utils import Shape as JShape
from bigdl_tpu.utils import SingleShape as JSingleShape
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch.tensor import Tensor as PTensor
from bigdl_tpu_torch.tensor.tensor import COVERAGE as P_COVERAGE
from bigdl_tpu_torch.utils import MultiShape, Shape, SingleShape
from bigdl_tpu_torch.utils.random import RandomGenerator


class _Jax:
    cls = JTensor
    kw = {}

    @staticmethod
    def T(*a, **k):
        return JTensor(*a, **k)


class _Port:
    cls = PTensor
    kw = {"device": "cpu"}

    @staticmethod
    def T(*a, **k):
        return PTensor(*a, device="cpu", **k)


def _a(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _plain(v):
    """A scenario's result as numpy / Python values (dtypes by name)."""
    if isinstance(v, (JTensor, PTensor)):
        return ("tensor", _dtype_name(v.dtype()), v.numpy())
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def _same(j, p, path="result"):
    if isinstance(j, np.ndarray):
        np.testing.assert_array_equal(p, j, err_msg=path)
    elif isinstance(j, tuple) and j and isinstance(j[0], str) and j[0] == "tensor":
        assert isinstance(p, tuple) and p[0] == "tensor", path
        assert j[1] == p[1], f"{path}: dtype {p[1]} vs JAX {j[1]}"
        assert j[2].shape == p[2].shape, f"{path}: shape {p[2].shape} vs JAX {j[2].shape}"
        if np.issubdtype(j[2].dtype, np.floating):
            np.testing.assert_allclose(p[2], j[2].astype(np.float64), rtol=1e-6, atol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(p[2], j[2], err_msg=path)
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(p), path
        for i, (a, b) in enumerate(zip(j, p)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(j, dict):
        assert set(j) == set(p), path
        for k in j:
            _same(j[k], p[k], f"{path}[{k}]")
    elif isinstance(j, float):
        assert p == pytest.approx(j, rel=1e-6, abs=1e-6), path
    else:
        assert p == j, path


# ------------------------------------------------------------- the scenarios
def _creation(k):
    t = k.T(2, 3)
    return {"size_ctor": (t.shape, t.sum(), t), "empty": k.T().is_empty(),
            "arange": k.cls.arange(1, 5, **k.kw), "arange_step": k.cls.arange(0, 1, 0.25, **k.kw),
            "zeros": k.cls.zeros(2, 2, **k.kw), "ones": k.cls.ones(3, **k.kw)}


def _meta(k):
    t = k.T(_a(2, 3, 4))
    return (t.dim(), t.n_dimension(), t.size(), t.size(2), t.n_element(),
            t.is_same_size_as(k.T(np.zeros((2, 3, 4)))), t.is_same_size_as(k.T(np.zeros(3))))


def _views(k):
    a = _a(4, 6)
    t = k.T(a)
    col = k.T(np.float32([[1], [2]]))
    s = k.T(_a(3, 1, 4))
    return {"narrow": t.narrow(2, 2, 3), "select": t.select(1, 3), "select_neg": t.select(2, -1),
            "view": t.view(2, 12), "view_tuple": t.view((3, 8)), "reshape": t.reshape(6, 4),
            "transpose": t.transpose(1, 2), "t": t.t(), "squeeze": s.squeeze(),
            "squeeze2": s.squeeze(2), "squeeze1": s.squeeze(1), "unsqueeze": s.unsqueeze(1),
            "expand": col.expand(2, 5), "repeat": col.repeat_tensor(2, 3),
            "split": k.T(_a(7, 2)).split(3, dim=1), "index_select": k.T(_a(5, 3)).index_select(
                1, [1, 5]), "contiguous": t.contiguous(), "clone": t.clone(),
            "getitem": t[1]}


def _access(k):
    a = _a(3, 3)
    t = k.T(a)
    before = t.value_at(2, 3)
    t.set_value(1, 1, 42.0)
    return before, t.value_at(1, 1), t.select(1, 1).select(1, 1).item(), t


def _mutating(k):
    a, b = _a(3, 3, seed=1), _a(3, 3, seed=2)
    t = k.T(_a(3, 4))
    out = t.fill(2.0).add(1.0).mul(3.0)
    u = k.T(b)
    dst = k.T(2, 3)
    dst.copy(k.T(np.arange(6, dtype=np.float32)))
    mask = k.T(np.float32([[1, 0, 1], [0, 1, 0]]))
    e = k.T(_a(4, seed=5))
    return {"fluent_is_self": out is t, "fluent": t,
            "add": k.T(a).add(u), "add_scaled": k.T(a).add(0.5, u), "add_scalar": k.T(a).add(2),
            "sub": k.T(a).sub(u), "sub_scaled": k.T(a).sub(0.5, u), "sub_scalar": k.T(a).sub(1.5),
            "cmul": k.T(a).cmul(u), "cdiv": k.T(a).cdiv(u), "cadd": k.T(a).cadd(2.0, u),
            "div": k.T(a).div(4.0), "pow": k.T(a).pow(2), "abs_sqrt": k.T(a).abs().sqrt(),
            "exp": k.T(a).exp(), "log": k.T(a).abs().log(), "log1p": k.T(a).abs().log1p(),
            "sign": k.T(a).sign(), "floor": k.T(a).floor(), "ceil": k.T(a).ceil(),
            "clamp": e.clamp(-0.5, 0.5), "negative": k.T(a).negative(), "tanh": k.T(a).tanh(),
            "sigmoid": k.T(a).sigmoid(), "zero": k.T(a).zero(), "copy": dst,
            "masked_fill": k.T(_a(2, 3, seed=6)).masked_fill(mask, 7.0),
            "resize": k.T(a).resize(2, 2), "resize_same": k.T(a).resize(3, 3),
            "resize_as": k.T(a).resize_as(k.T(np.zeros((1, 4), np.float32)))}


def _blas(k):
    t, u, v = k.T(_a(3, 4, seed=7)), k.T(_a(4, 2, seed=8)), k.T(_a(4, seed=9))
    m, x, y = _a(2, 2, seed=10), k.T(_a(2, 3, seed=11)), k.T(_a(3, 2, seed=12))
    return {"mm": t.mm(u), "mv": t.mv(v), "dot": v.dot(v),
            "addmm": k.T(m).addmm(0.5, k.T(m), 2.0, x, y),
            "addmv": k.T(_a(3, seed=13)).addmv(0.5, k.T(_a(3, seed=13)), 2.0, t, v)}


def _reductions(k):
    t = k.T(_a(3, 4, seed=13))
    m = k.T(np.float32([[1, 3, 2], [9, 0, 4]]))
    top = k.T(np.float32([5, 1, 4, 2, 3]))
    ties = k.T(np.float32([2, 5, 5, 1, 2]))
    u, w = k.T(_a(5, seed=14)), k.T(_a(5, seed=15))
    return {"sum": t.sum(), "mean": t.mean(), "sum2": t.sum(2), "mean1": t.mean(1),
            "max": t.max(), "min": t.min(), "max2": m.max(2), "min1": m.min(1),
            "prod": k.T(np.float32([1.5, 2, -3])).prod(), "topk": top.topk(2),
            "topk_inc": top.topk(2, increase=True), "topk_ties": ties.topk(3),
            "topk_ties_inc": ties.topk(2, increase=True), "topk_dim": m.topk(1, dim=1),
            "norm2": u.norm(2), "norm1": u.norm(1), "norm3": u.norm(3), "dist": u.dist(w),
            "sort": k.T(np.float32([[3, 1, 2]])).sort(),
            "sort_desc": k.T(np.float32([[3, 1, 2]])).sort(descending=True),
            "sort_ties": ties.sort(), "sort_ties_desc": ties.sort(descending=True),
            "cumsum": k.T(np.float32([[1, 2, 3], [4, 5, 6]])).cumsum(2),
            "cumprod": k.T(np.float32([[1, 2, 3], [4, 5, 6]])).cumprod(1),
            "kthvalue": top.kthvalue(2), "kthvalue_ties": ties.kthvalue(3)}


def _tier2(k):
    g = k.T(np.float32([[10, 20], [30, 40]])).gather(2, k.T(np.float32([[2], [1]])))
    sel = k.T(np.float32([1, 2, 3, 4])).masked_select(k.T(np.float32([1, 0, 1, 0])))
    fill = k.T(np.zeros((2, 3), np.float32)).index_fill(2, [1, 3], 9.0)
    fill1 = k.T(np.zeros((3, 3), np.float32)).index_fill(1, 2, 7.0)
    return {"gather": g, "masked_select": sel, "index_fill": fill, "index_fill_scalar": fill1}


def _comparisons(k):
    a = np.float32([1, 2, 3])
    t, o = k.T(a), k.T(np.float32([3, 2, 1]))
    return {"gt": t.gt(2), "le": t.le(2), "eq": t.eq(2), "ne": t.ne(2), "lt": t.lt(o),
            "ge": t.ge(o), "same": k.T(a) == k.T(a.copy()),
            "differs": k.T(a) == k.T(np.float32([1, 3, 3])),
            "shape_differs": k.T(a) == k.T(np.float32([1, 2])),
            "almost": k.T(a).almost_equal(k.T(a + 1e-8), 1e-6),
            "not_almost": k.T(a).almost_equal(k.T(a + 1e-3), 1e-6),
            "ops": (t + o, t - o, t * o, t / o, -t, t + 1, 2 * t, t / 2)}


def _dtypes(k):
    """The JAX dtype rules: 64-bit narrowed, integer sums int32, a 0-dim
    float32 operand promoting bfloat16, a Python scalar keeping it."""
    i = k.T(np.arange(6, dtype=np.int64).reshape(2, 3))
    f64 = k.T(np.ones(3, np.float64))
    out = {"int64_in": i, "float64_in": f64, "list_in": k.T([1, 2, 3]),
           "int_sum2": i.sum(2), "int_cumsum": i.cumsum(2), "int_mean": i.mean(2),
           "int_plus_half": i + 0.5, "int_times_2": i * 2, "int_cmp": i.gt(2),
           "int_max": i.max(2), "int_div": i / 2}
    if k is _Port:
        bf = k.T(torch.ones(3, dtype=torch.bfloat16))
        zero_d = k.T(torch.tensor(2.0))
    else:
        import jax.numpy as jnp

        bf = k.T(jnp.ones(3, jnp.bfloat16))
        zero_d = k.T(jnp.float32(2.0))
    out.update(bf16_div_0d=bf / zero_d, bf16_times_scalar=bf * 2.0,
               bf16_cmul_0d=k.T(bf).cmul(zero_d), bf16_add_scalar=k.T(bf).add(1.0))
    return out


def _random_fills(k):
    t = k.T(100)
    u = t.clone().uniform(0, 1)
    n = t.clone().normal(5.0, 0.1)
    b = t.clone().bernoulli(0.5)
    r, s = k.cls.randn(100, seed=0, **k.kw), k.cls.rand(100, **k.kw)
    return [(x.shape, _dtype_name(x.dtype())) for x in (u, n, b, r, s)] + [
        bool(0.2 < u.numpy().mean() < 0.8), bool(abs(n.numpy().mean() - 5.0) < 0.1),
        bool(set(np.unique(b.numpy())) <= {0.0, 1.0}), bool(r.numpy().std() > 0.5),
        bool(0.0 <= s.numpy().min() and s.numpy().max() <= 1.0)]


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _creation, _meta, _views, _access, _mutating, _blas, _reductions, _tier2, _comparisons,
    _dtypes, _random_fills)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_facade_matches_jax(name):
    JRandom.set_seed(21)
    RandomGenerator.set_seed(21)
    _same(_plain(SCENARIOS[name](_Jax)), _plain(SCENARIOS[name](_Port)))


# --------------------------------------------------------------- no aliasing
def _no_aliasing(k):
    """Each view method's result mutated, then its parent: neither sees the
    other's change. Returns every tensor's values after both writes."""
    out = {}
    for name, view in (("narrow", lambda t: t.narrow(1, 1, 2)),
                       ("select", lambda t: t.select(1, 2)),
                       ("transpose", lambda t: t.transpose(1, 2)),
                       ("t", lambda t: t.t()), ("view", lambda t: t.view(6)),
                       ("reshape", lambda t: t.reshape(2, 3)),
                       ("squeeze", lambda t: t.unsqueeze(1).squeeze()),
                       ("expand", lambda t: t.narrow(1, 1, 1).expand(3, 2)),
                       ("clone", lambda t: t.clone()), ("getitem", lambda t: t[0]),
                       ("split", lambda t: t.split(2)[0]), ("copy_ctor", lambda t: k.T(t))):
        parent = k.T(np.arange(6, dtype=np.float32).reshape(3, 2))
        v = view(parent)
        v.fill(9.0)
        after_view = parent.numpy().copy()
        parent.zero().add(5.0)
        v.add(1.0).copy(v.clone().mul(2.0))
        parent.set_value(1, 1, -1.0)
        out[name] = (after_view, parent, v)
    return out


def test_views_never_alias_in_either_package():
    j, p = _plain(_no_aliasing(_Jax)), _plain(_no_aliasing(_Port))
    _same(j, p)
    for name, (after_view, parent, v) in p.items():
        np.testing.assert_array_equal(after_view, np.arange(6, dtype=np.float32).reshape(3, 2),
                                      err_msg=name)  # the view's fill did not reach the parent
        assert (v[2] == 20.0).all(), name  # nor the parent's writes the view


def test_port_copies_a_tensor_it_is_given():
    src = torch.arange(4, dtype=torch.float32)
    t = PTensor(src, device="cpu")
    src.fill_(7.0)
    np.testing.assert_array_equal(t.numpy(), [0, 1, 2, 3])
    u = PTensor(t)
    u.data.fill_(3.0)  # even an in-place write through .data stays in that façade
    np.testing.assert_array_equal(t.numpy(), [0, 1, 2, 3])


def test_coverage_tables_are_equal_and_accurate():
    assert P_COVERAGE == J_COVERAGE
    for group, names in P_COVERAGE.items():
        for name in names:
            assert hasattr(PTensor, name), f"{group}.{name} missing"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert PTensor(2).data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PTensor(2)


# ---------------------------------------------------------------------- Shape
@pytest.mark.parametrize("value", [[3, 4], (2,), [[1, 2], [3]], [(1,), [2, 3], [4]]])
def test_shape_of_matches_jax(value):
    got, want = Shape.of(value), JShape.of(value)
    assert repr(got) == repr(want)
    assert type(got).__name__ == type(want).__name__
    assert Shape.of(got) is got


def test_single_and_multi_shape_match_jax():
    s, js = SingleShape([2, 3]), JSingleShape([2, 3])
    assert s.to_tuple() == js.to_tuple() == (2, 3) and repr(s) == repr(js)
    assert s == SingleShape((2, 3)) and s != SingleShape([3, 2]) and s != MultiShape([s])
    m, jm = MultiShape([s, SingleShape([4])]), JMultiShape([js, JSingleShape([4])])
    assert repr(m) == repr(jm) and m == MultiShape([SingleShape([2, 3]), SingleShape([4])])
    assert m != MultiShape([s])
