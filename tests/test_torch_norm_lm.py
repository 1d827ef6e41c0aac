"""The norm-LM (the pipeline example's pre-norm block-stack language model)
in the port against the JAX package, both variants: LayerNormalization as
the example builds it, and RMSNorm in each of its places.

    Sequential(LookupTable(V, H),
               PipelinedBlocks(Graph: norm(H) -> FeedForwardNetwork(H, 4H)
                               -> CAddTable residual, S),
               norm(H), Linear(H, V))

At V 64, H 32, S 3, T 16, batch 4, f32, the JAX model's weights carried
over (stage-stacked leaves included), tokens from the example's
planted-bigram stream:
(a) logits with the fused-kernel switch on (the JAX kernels in interpret
    mode, the port's plain versions) and off;
(b) 3 ``LocalOptimizer`` steps with ``Adam(3e-3)`` and
    ``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``
    against the JAX ``LocalOptimizer``, the switch on in both, over 8
    records (an epoch boundary after step 2): losses and parameters;
(c) the bf16 activation policy: each node's output dtype in both packages.
Tolerances (f32; the same products summed in another order): logits
1e-5 and losses 1e-5, fixed before the first run. The parameters were first
held elementwise to 1e-4; one weight of the RMSNorm variant's FFN out_w
ended 1.3e-4 apart after 3 steps. Adam divides each step by sqrt(v), so a
gradient near zero (a ReLU unit that fired once, faintly) steps by up to lr
either way on a 1e-7 difference. So the parameters are held as Adam allows:
the whole update (final minus initial parameters) within 1e-3 of its norm
by relative L2 (readings: 1.0e-5 LayerNorm, 1.1e-4 RMSNorm), and every
parameter within 2·lr a step of JAX's.

The 3 Adam steps of both packages run in one fresh child process (this file
run as a script) with torch on one thread, so that process-wide state left
by other test files on the same xdist worker (either package's engine and
dtype policy, JAX config and compile caches, torch's threads) cannot reach
them; the allowances and checks run here. The child also runs the same
steps in float64 (written out from the JAX package's definitions) and
records what it ran with (its environment, ``jax.config``, torch's threads
and CPU capability); a failing check names each side's distance from that
float64 run and keeps the child's arrays and record under
``build/test_failures/``. Both sides' readings move with the CPU's vector
instructions (torch's kernel dispatch, XLA's target): on one machine the
RMSNorm variant's relative L2 read 3.2e-5 to 1.1e-4 over those choices,
each side 2e-4 to 3e-4 from the float64 run on the same element.
"""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.ops import fused_norm
from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T as PT

V, H, S, SEQ, BATCH, N_REC, SEED = 64, 32, 3, 16, 4, 8, 11
VARIANTS = ["ln", "rms"]


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _policy_and_switches():
    j_prev = (JEngine._state.fused_kernels, JEngine._state.compute_dtype,
              JEngine._state.activation_dtype)
    p_prev = Engine._fused_kernels
    JEngine.set_compute_dtype(None)
    JEngine.set_activation_dtype(None)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)
    Engine._fused_kernels = p_prev
    (JEngine._state.fused_kernels, JEngine._state.compute_dtype,
     JEngine._state.activation_dtype) = j_prev


ROOT = Path(__file__).resolve().parents[1]


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the LM examples' planted-bigram token stream (stdlib + numpy only)
planted_bigram_ids = _load_file("_examples_common", ROOT / "examples" / "_common.py") \
    .planted_bigram_ids


def test_chip_smoke_copies_the_examples_token_stream():
    """The port keeps one copy of the generator, in its Transformer example
    (it imports nothing of the JAX package's tree), and ``chip_smoke.py``
    takes it from there: the copy gives the same ids as the examples' own.
    The script is read as source, since importing it blocks JAX in this
    process."""
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids as port_ids

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assert not any(isinstance(n, ast.FunctionDef) and n.name == "planted_bigram_ids"
                   for n in tree.body)
    assert any(isinstance(n, ast.ImportFrom)
               and n.module == "bigdl_tpu_torch.examples.transformer_train"
               and [a.name for a in n.names] == ["planted_bigram_ids"]
               for n in ast.walk(tree))
    for seed in (0, 7):
        np.testing.assert_array_equal(port_ids(5000, 8192, seed=seed),
                                      planted_bigram_ids(5000, 8192, seed=seed))


def _data():
    ids = planted_bigram_ids(N_REC * SEQ + 1, V)
    return ids[:-1].reshape(N_REC, SEQ), ids[1:].reshape(N_REC, SEQ)


def norm_lm(nn, variant, **dev):
    def norm():
        return nn.LayerNormalization(H, **dev) if variant == "ln" else nn.RMSNorm(H, **dev)

    inp = nn.Input()
    ln = norm().inputs(inp)
    ffn = nn.FeedForwardNetwork(H, filter_size=4 * H, **dev).inputs(ln)
    add = nn.CAddTable(**dev).inputs(inp, ffn)
    return nn.Sequential(nn.LookupTable(V, H, **dev),
                         nn.PipelinedBlocks(nn.Graph(inp, add, **dev), S, **dev),
                         norm(), nn.Linear(H, V, **dev), **dev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(variant, x):
    JRandom.set_seed(SEED)
    jm = norm_lm(jnn, variant)
    jm.init(jax.random.PRNGKey(SEED), sample_input=jnp.asarray(x[:BATCH]))
    init = _np_tree(jm.get_parameters())
    RandomGenerator.set_seed(SEED)
    pm = norm_lm(pnn, variant, device="cpu")
    pm.init(sample_input=x[:BATCH])
    load_jax_params(pm, init)
    return jm, pm, init


@pytest.mark.parametrize("switch", [True, False], ids=["switch-on", "switch-off"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_match_jax(variant, switch):
    x, _ = _data()
    jm, pm, _ = _models(variant, x)
    JEngine.set_fused_kernels(switch)
    Engine.set_fused_kernels(switch)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    got = pm.forward(x)
    assert got.shape == (N_REC, SEQ, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_parameter_counts():
    """At the chip run's widths (V 8192, H 512, S 6), built on ``meta``."""
    import bigdl_tpu_torch.nn as nn

    global V, H, S
    saved = V, H, S
    V, H, S = 8192, 512, 6
    try:
        counts = {}
        for variant in VARIANTS:
            m = norm_lm(nn, variant, device="meta")
            m.init(sample_input=torch.zeros((1, 4), dtype=torch.int64, device="meta"))
            counts[variant] = m.n_parameters()
    finally:
        V, H, S = saved
    assert counts == {"ln": 21_002_240, "rms": 20_998_656}


class _RecordingJaxOptimizer(joptim.LocalOptimizer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.losses = []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


LR, STEPS = 3e-3, 3


def _adam_runs(variant):
    """Both packages' 3 Adam steps and the float64 run, as arrays (what the
    child process computes for one variant)."""
    x, y = _data()
    jm, pm, init = _models(variant, x)
    JEngine.set_fused_kernels(True)
    Engine.set_fused_kernels(True)
    crit = dict(size_average=True)
    JRandom.set_seed(SEED)
    jopt = _RecordingJaxOptimizer(jm, JDataSet.array(x, y, batch_size=BATCH),
                                  jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(),
                                                               **crit))
    jopt.set_optim_method(joptim.Adam(learningrate=LR))
    jopt.set_end_when(joptim.Trigger.max_iteration(STEPS)).optimize()
    RandomGenerator.set_seed(SEED)
    popt = LocalOptimizer(pm, DataSet.array(x, y, batch_size=BATCH),
                          pnn.TimeDistributedCriterion(pnn.CrossEntropyCriterion(), **crit))
    popt.set_optim_method(Adam(learningrate=LR))
    before = (fused_norm.launches_layer_norm_fwd, fused_norm.launches_rms_norm_fwd)
    popt.set_end_when(Trigger.max_iteration(STEPS)).optimize()
    after = (fused_norm.launches_layer_norm_fwd, fused_norm.launches_rms_norm_fwd)
    f64_losses, f64 = _float64_adam(variant, _flat(init), x, y)
    out = {"jax_losses": np.asarray(jopt.losses), "f64_losses": np.asarray(f64_losses),
           "port_losses": np.asarray([h["loss"] for h in popt.history]),
           "kernel_launches": np.asarray([after[0] - before[0], after[1] - before[1]])}
    for side, tree in (("jax", _flat(_np_tree(jm.get_parameters()))),
                       ("port", _flat(pm.get_parameters())), ("init", _flat(init)), ("f64", f64)):
        out.update({f"{side}:{k}": v for k, v in tree.items()})
    return out


def _float64_adam(variant, init, x, y):
    """The same steps in float64: the model, the loss and ``Adam`` written out
    from the JAX package's definitions (RMSNorm eps 1e-6 without a bias,
    LayerNormalization eps 1e-5; FFN relu(x W_f^T + b_f) W_o^T + b_o; mean
    cross-entropy over batch and time; the epoch order that both
    ``DataSet.array``s draw from ``(seed, epoch)``). ``(losses, params)``."""
    P = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
         for k, v in init.items()}
    names = sorted(P)

    def one(prefix, suffix):
        return next(P[k] for k in names if k.startswith(prefix) and k.endswith(suffix))

    def norm(h, w, b):
        if variant == "rms":
            return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6) * w
        mu = h.mean(-1, keepdim=True)
        return (h - mu) / torch.sqrt(((h - mu) ** 2).mean(-1, keepdim=True) + 1e-5) * w + b

    stage = [k for k in names if ".stages." in k]
    final = [k for k in names if k.split(".")[0].startswith(("LayerNormalization", "RMSNorm"))]
    is_norm = [k for k in stage if k.split(".stages.")[1].startswith(("LayerNorm", "RMSNorm"))]

    def forward(ids):
        h = one("LookupTable", "weight")[torch.as_tensor(ids, dtype=torch.long)]
        for i in range(S):
            st = {k.rsplit(".", 1)[1]: P[k][i] for k in stage if k not in is_norm}
            ns = {k.rsplit(".", 1)[1]: P[k][i] for k in is_norm}
            z = norm(h, ns["weight"], ns.get("bias"))
            hid = torch.relu(z @ st["filter_w"].T + st["filter_b"])
            h = h + hid @ st["out_w"].T + st["out_b"]
        fw = {k.rsplit(".", 1)[1]: P[k] for k in final}
        h = norm(h, fw["weight"], fw.get("bias"))
        return h @ one("Linear", "weight").T + one("Linear", "bias")

    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, epoch = [], 1
    while len(losses) < STEPS:
        order = np.random.default_rng((SEED, epoch)).permutation(len(x))
        for b0 in range(0, len(x) - BATCH + 1, BATCH):
            if len(losses) == STEPS:
                break
            idx = order[b0:b0 + BATCH]
            logp = torch.log_softmax(forward(x[idx]), -1)
            loss = -logp.gather(-1, torch.as_tensor(y[idx], dtype=torch.long)[..., None]).mean()
            grads = torch.autograd.grad(loss, [P[k] for k in names])
            losses.append(loss.item())
            t = len(losses)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k] = 0.9 * m[k] + 0.1 * g
                    v2[k] = 0.999 * v2[k] + 0.001 * g * g
                    P[k] -= LR * (m[k] / (1 - 0.9 ** t)) / (torch.sqrt(v2[k] / (1 - 0.999 ** t))
                                                            + 1e-8)
        epoch += 1
    return losses, {k: P[k].detach().numpy() for k in names}


def _run_adam_cases(out_path):
    """Every variant's runs saved to ``out_path`` as ``{variant}/{key}`` (what
    the child process runs), its record beside them."""
    JEngine.reset()
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    arrays = {}
    for variant in VARIANTS:
        arrays.update({f"{variant}/{k}": v for k, v in _adam_runs(variant).items()})
    np.savez(out_path, **arrays)
    with open(str(out_path) + ".json", "w") as f:
        json.dump({"env": dict(os.environ), "jax_config": dict(jax.config.values),
                   "jax": jax.__version__, "torch": torch.__version__,
                   "torch_threads": torch.get_num_threads(),
                   "torch_cpu_capability": torch.backends.cpu.get_cpu_capability(),
                   "numpy": np.__version__, "pid": os.getpid(), "cpus": os.cpu_count()},
                  f, indent=1, sort_keys=True, default=repr)


@pytest.fixture(scope="module")
def adam_runs(tmp_path_factory):
    """``({variant: {key: array}}, path of the child's arrays)`` from a fresh process."""
    out = tmp_path_factory.mktemp("norm_lm_adam") / "adam.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    runs = {v: {} for v in VARIANTS}
    with np.load(out) as f:
        for key in f.files:
            variant, name = key.split("/", 1)
            runs[variant][name] = f[key]
    return runs, out


def _side(run, side):
    return {k.split(":", 1)[1]: v for k, v in run.items() if k.startswith(side + ":")}


@pytest.mark.parametrize("variant", VARIANTS)
def test_three_adam_steps_match_jax(variant, adam_runs):
    runs, out = adam_runs
    run = runs[variant]
    want, got, p0, f64 = (_side(run, s) for s in ("jax", "port", "init", "f64"))
    update = np.sqrt(sum(np.sum((want[k] - p0[k]) ** 2) for k in want))

    def rel_l2(a, b):
        return np.sqrt(sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in b)) / update

    try:
        assert list(run["kernel_launches"]) == [0, 0]  # CPU: plain versions only
        assert len(run["port_losses"]) == len(run["jax_losses"]) == STEPS
        np.testing.assert_allclose(run["port_losses"], run["jax_losses"], rtol=1e-5, atol=1e-5)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STEPS * 2 * LR, err_msg=k)
        assert rel_l2(got, want) <= 1e-3, (rel_l2(got, want), update)
    except AssertionError as e:
        dest = os.path.join(str(ROOT), "build", "test_failures",
                            f"norm_lm_adam_{variant}_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}")
        os.makedirs(dest, exist_ok=True)
        for src in (str(out), str(out) + ".json"):
            shutil.copy(src, dest)
        raise AssertionError(
            f"{e}\nagainst the float64 run: port rel L2 {rel_l2(got, f64):.3e}, losses "
            f"{np.abs(run['port_losses'] - run['f64_losses']).max():.3e}; jax rel L2 "
            f"{rel_l2(want, f64):.3e}, losses {np.abs(run['jax_losses'] - run['f64_losses']).max():.3e}"
            f"; the child's arrays and record are kept in {dest}") from e


def test_float64_run_tracks_both_packages(adam_runs):
    """The float64 run the failure messages measure against follows both
    packages: losses within 1e-5 of each (readings: 4e-6 at most), and
    parameters within 1e-2 of the update by relative L2 (readings: 2e-4 to
    3.4e-4 on one element; a float64 run with other semantics, such as
    another epoch order or eps, lands O(1) apart)."""
    runs, _ = adam_runs
    for run in runs.values():
        want, got, p0, f64 = (_side(run, s) for s in ("jax", "port", "init", "f64"))
        update = np.sqrt(sum(np.sum((f64[k] - p0[k]) ** 2) for k in f64))
        for side, losses in ((want, run["jax_losses"]), (got, run["port_losses"])):
            np.testing.assert_allclose(losses, run["f64_losses"], rtol=1e-5, atol=1e-5)
            d = np.sqrt(sum(np.sum((side[k].astype(np.float64) - f64[k]) ** 2) for k in f64))
            assert d <= 1e-2 * update, (d, update)


def _node_outputs(seq, params, x, T, pipelined_stage):
    """Each node's output on the eval path: the embedding, one stage's norm,
    FFN and residual add, the stack, the final norm and the head."""
    names = [m.name() for m in (seq[0], seq[1], seq[2], seq[3])]
    emb = seq[0].apply(params[names[0]], {}, x)[0]
    stage = pipelined_stage(seq[1])
    sp = jax.tree_util.tree_map(lambda a: a[0], params[names[1]]["stages"]) if isinstance(
        emb, jax.Array) else {k: {n: t[0] for n, t in v.items()}
                              for k, v in params[names[1]]["stages"].items()}
    norm, ffn, add = stage[0], stage[1], stage[2]
    h1 = norm.apply(sp[norm.name()], {}, emb)[0]
    h2 = ffn.apply(sp[ffn.name()], {}, h1)[0]
    h3 = add.apply({}, {}, T(emb, h2))[0]
    out = seq[1].apply(params[names[1]], {}, emb)[0]
    fin = seq[2].apply(params[names[2]], {}, out)[0]
    head = seq[3].apply(params[names[3]], {}, fin)[0]
    return [str(a.dtype).replace("torch.", "") for a in (emb, h1, h2, h3, out, fin, head)]


@pytest.mark.parametrize("switch", [True, False], ids=["switch-on", "switch-off"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_activation_policy_node_by_node(variant, switch):
    """bf16 compute and activations: the embedding, the FFN and so the whole
    residual stream and the norms stay fp32; only the head's output is bf16."""
    x, _ = _data()
    jm, pm, init = _models(variant, x)
    JEngine.set_compute_dtype("bfloat16")
    JEngine.set_activation_dtype("bfloat16")
    JEngine.set_fused_kernels(switch)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(switch)
    want = _node_outputs(jm, jax.tree_util.tree_map(jnp.asarray, init), jnp.asarray(x), JT,
                         lambda stack: stack.stage)
    got = _node_outputs(pm, pm.get_parameters(), torch.from_numpy(x), PT,
                        lambda stack: stack._runner)
    assert got == want == ["float32"] * 6 + ["bfloat16"]


if __name__ == "__main__":  # the child process of the ``adam_runs`` fixture
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    _run_adam_cases(sys.argv[1])
