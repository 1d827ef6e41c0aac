"""L-BFGS with an optional strong-Wolfe line search (counterpart of
``bigdl_tpu/optim/lbfgs.py``; reference: ``$DL/optim/LBFGS.scala`` and
``LineSearch.scala``, ports of torch/optim's lbfgs.lua).

L-BFGS is closure-driven: the line search evaluates the loss at trial
points, so the method implements ``optimize(feval, params)`` and its
``init_slots``/``update`` raise (it is used with a full-batch ``feval``,
not inside ``LocalOptimizer``'s per-batch loop, as in the reference).
``feval(params) -> (loss, grads)`` runs on the parameters' device; the
two-loop recursion and the line search are float64 host math (numpy) over
the raveled parameters, as in the JAX package. Parameters and gradients
are raveled in the JAX package's order (dict keys sorted at every level,
as ``ravel_pytree`` flattens them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optim_method import OptimMethod


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through (x1,f1,g1),(x2,f2,g2) (torch's polyinterp)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 * d1 - g1 * g2
    if d2_square >= 0:
        d2 = np.sqrt(d2_square)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def _strong_wolfe(
    obj_func: Callable[[np.ndarray, float, np.ndarray], Tuple[float, np.ndarray]],
    x: np.ndarray,
    t: float,
    d: np.ndarray,
    f: float,
    g: np.ndarray,
    gtd: float,
    c1: float = 1e-4,
    c2: float = 0.9,
    tolerance_change: float = 1e-9,
    max_ls: int = 25,
):
    """lswolfe (reference: LineSearch.lswolfe): bracket + zoom with cubic
    interpolation. Returns (f_new, g_new, t, n_evals)."""
    d_norm = np.abs(d).max()
    g = g.copy()
    f_new, g_new = obj_func(x, t, d)
    ls_func_evals = 1
    gtd_new = float(g_new @ d)

    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.copy()]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket = [t, t]
            bracket_f = [f_new, f_new]
            bracket_g = [g_new, g_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.copy()]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                               bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new.copy(), gtd_new
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = float(g_new @ d)
        ls_iter += 1
    else:
        bracket = [0.0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]
        bracket_gtd = [gtd, gtd_new]

    # zoom
    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(
            bracket[0], bracket_f[0], bracket_gtd[0],
            bracket[1], bracket_f[1], bracket_gtd[1],
        )
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                t = max(bracket) - eps if abs(t - max(bracket)) < abs(t - min(bracket)) else min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = float(g_new @ d)
        ls_iter += 1
        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new.copy()
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.copy()
            bracket_gtd[low_pos] = gtd_new

    t = bracket[low_pos] if not done else t
    f_new = bracket_f[low_pos] if not done else f_new
    g_new = bracket_g[low_pos] if not done else g_new
    return f_new, g_new, t, ls_func_evals


class LBFGS(OptimMethod):
    """Limited-memory BFGS (reference constructor: ``LBFGS(maxIter, maxEval,
    tolFun, tolX, nCorrection, learningRate, lineSearch)``).
    ``line_search="lswolfe"`` takes the strong-Wolfe search; otherwise a
    fixed step of ``learningrate`` (the first scaled by ``min(1, 1/|g|_1)``).
    ``max_eval`` (default ``1.25 * max_iter``) stops the run once that many
    evaluations are made; the line search of the last iteration may make
    more before the check."""

    elementwise = False

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolfun: float = 1e-5, tolx: float = 1e-9, ncorrection: int = 100,
                 learningrate: float = 1.0, line_search: Optional[str] = None):
        super().__init__()
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.tolfun = tolfun
        self.tolx = tolx
        self.ncorrection = ncorrection
        self.learningrate = learningrate
        if line_search not in (None, "lswolfe"):
            raise ValueError(f"unknown line_search {line_search!r}")
        self.line_search = line_search

    def init_slots(self, params):
        raise NotImplementedError(
            "LBFGS is closure-driven; use optimize(feval, params) with a "
            "full-batch feval (reference behavior), not the per-batch training loop")

    def update(self, grads, params, slots, lr, step):
        self.init_slots(params)

    def optimize(self, feval, params):
        """Run up to ``max_iter`` L-BFGS iterations from ``params`` (a nested
        dict of tensors, left untouched). ``feval(params) -> (loss,
        grads)`` with ``grads`` a tree like ``params``. Returns ``(params,
        [loss history])``: new tensors on ``params``' device and dtypes."""
        paths = _sorted_paths(params)
        like = [_get(params, p) for p in paths]
        x = np.concatenate([t.detach().cpu().double().reshape(-1).numpy() for t in like])

        def unravel(xv: np.ndarray) -> Dict[str, Any]:
            out = _skeleton(params)  # sub-trees without leaves kept, as unflatten does
            at = 0
            for path, t in zip(paths, like):
                n = t.numel()
                leaf = torch.from_numpy(np.ascontiguousarray(xv[at:at + n])).to(
                    device=t.device, dtype=t.dtype).reshape(t.shape)
                _set(out, path, leaf)
                at += n
            return out

        def f(xv: np.ndarray) -> Tuple[float, np.ndarray]:
            loss, grads = feval(unravel(xv))
            g = np.concatenate([_get(grads, p).detach().cpu().double().reshape(-1).numpy()
                                for p in paths])
            return float(loss), g

        loss, g = f(x)
        history: List[float] = [loss]
        n_evals = 1
        if np.abs(g).max() <= self.tolfun:
            return unravel(x), history

        old_dirs: List[np.ndarray] = []  # s_k
        old_stps: List[np.ndarray] = []  # y_k
        ro: List[float] = []
        h_diag = 1.0
        g_prev = None
        d = None
        t = float(self.learningrate)

        for n_iter in range(self.max_iter):
            if n_iter == 0:
                d = -g
            else:
                y = g - g_prev
                s = d * t
                ys = float(y @ s)
                if ys > 1e-10:
                    if len(old_dirs) == self.ncorrection:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                        ro.pop(0)
                    old_dirs.append(s)
                    old_stps.append(y)
                    ro.append(1.0 / ys)
                    h_diag = ys / float(y @ y)
                # two-loop recursion
                q = -g
                m = len(old_dirs)
                al = [0.0] * m
                for i in range(m - 1, -1, -1):
                    al[i] = float(old_dirs[i] @ q) * ro[i]
                    q = q - al[i] * old_stps[i]
                d = q * h_diag
                for i in range(m):
                    be_i = float(old_stps[i] @ d) * ro[i]
                    d = d + old_dirs[i] * (al[i] - be_i)
            g_prev = g.copy()
            gtd = float(g @ d)
            if gtd > -self.tolx:
                break
            if n_iter == 0:
                t = min(1.0, 1.0 / np.abs(g).sum()) * self.learningrate
            else:
                t = float(self.learningrate)

            if self.line_search == "lswolfe":
                def obj(xv, tt, dd):
                    return f(xv + tt * dd)

                loss, g, t, evals = _strong_wolfe(obj, x, t, d, loss, g, gtd)
                n_evals += evals
                x = x + t * d
            else:
                x = x + t * d
                loss, g = f(x)
                n_evals += 1
            history.append(loss)
            self.state["neval"] = self.state.get("neval", 1) + 1

            if np.abs(g).max() <= self.tolfun:
                break
            if np.abs(d * t).max() <= self.tolx:
                break
            if len(history) > 1 and abs(history[-1] - history[-2]) < self.tolx:
                break
            if n_evals >= self.max_eval:
                break

        return unravel(x), history


def _sorted_paths(tree: Dict[str, Any], prefix: tuple = ()) -> List[tuple]:
    """Key paths of the leaves, keys sorted at every level (``ravel_pytree``'s
    order)."""
    out: List[tuple] = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(_sorted_paths(val, prefix + (key,)))
        else:
            out.append(prefix + (key,))
    return out


def _get(tree: Dict[str, Any], path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict[str, Any], path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = leaf


def _skeleton(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree``'s nested dicts, every leaf None."""
    return {k: (_skeleton(v) if isinstance(v, dict) else None) for k, v in tree.items()}
