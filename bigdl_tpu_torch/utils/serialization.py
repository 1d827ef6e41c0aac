"""Checkpoint persistence (counterpart of the classic-checkpoint part of
``bigdl_tpu/utils/serialization.py``), byte-compatible with the JAX package:
each package reads the other's checkpoints.

A checkpoint is the step-tagged state of a run, written as ``.npz`` of
flattened '/'-joined key paths plus JSON:

    <dir>/model.<step>.npz        params/... and model_state/... (BN running statistics)
    <dir>/optimMethod.<step>.npz  slots/... (e.g. slots/velocity/...)
    <dir>/state.<step>.json       the host state table (epoch, neval, _iter_in_epoch,
                                  loss, score, ...) and the RNG position
                                  (_rng_seed, _rng_counter)
    <dir>/manifest.<step>.json    sha256 + size per file and a params/model-state
                                  finiteness flag, written LAST (atomic rename):
                                  its presence marks the checkpoint complete

Every ``.npz`` is written to a temporary name, hashed as it is written and
renamed into place. ``load_checkpoint(step=None)`` verifies newest-first and
falls back to the newest older checkpoint that verifies, so a truncated or
corrupt latest checkpoint is logged and skipped; an explicit ``step`` that
fails verification raises :class:`~bigdl_tpu_torch.resilience.errors.CheckpointCorrupt`.
``keep_last=N`` prunes all but the N newest (always keeping the newest
finite one).

Leaves are torch tensors (copied to the host) or numpy arrays. A bf16 leaf
is stored as the JAX package stores one (numpy has no bfloat16: its 2-byte
raw values, dtype ``|V2``) and read back into a bf16 tensor; the port's
parameters, slots and BN statistics are fp32, so training writes none.

Fleet checkpoints (the JAX package's per-host-sharded format of its
elastic runs): ``shard.p<k>.<step>.npz`` holds process k's ``[lo, hi)``
slice of the padded flat master and of each flat slot vector (scalar slot
state and the model state whole in every shard), and the fleet
``manifest.<step>.json`` (written last) the codec's geometry, the shards'
bounds and hashes and the fleet generation. ``save_fleet_checkpoint`` /
``save_fleet_shard`` / ``save_fleet_manifest`` write one, and
``load_fleet_checkpoint`` assembles the full vectors; ``load_checkpoint``
reads one into the tree view through the model's ``FlatParameter``
(``params_like``): verified, a tampered or missing shard is
``CheckpointCorrupt``, a codec that is not the model's or a generation
under ``min_generation`` is ``ArtifactIncompatible``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..resilience.errors import ArtifactIncompatible, CheckpointCorrupt
from .random import RandomGenerator

log = logging.getLogger(__name__)

MANIFEST_FORMAT = 1
FLEET_KIND = "fleet"
_BF16_RAW = np.dtype("V2")  # how numpy stores the JAX package's bfloat16 leaves


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RAW)
        return t.numpy()
    return np.asarray(leaf)


def tree_items(tree, prefix: str = "") -> Dict[str, Any]:
    """``{'a/b/c': leaf}`` over nested dicts, lists and tuples in the tree's
    order (None leaves are skipped), the leaves as they are; the paths are
    the JAX package's checkpoint keys. :func:`unflatten_to_like` rebuilds."""
    out: Dict[str, Any] = {}
    _collect_items(tree, prefix, out)
    return out


# The tree walks below are module-level functions, not closures that call
# themselves: such a closure refers to itself through its cell, and the
# cycle would hold what it closes over (the leaves: parameters and slots on
# the device) until the cyclic collector runs.
def _collect_items(node, path: str, out: Dict[str, Any]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _collect_items(v, f"{path}/{k}" if path else str(k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _collect_items(v, f"{path}/{i}" if path else str(i), out)
    elif node is not None:
        out[path] = node


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{'a/b/c': host array}``, as the JAX package flattens a pytree."""
    return {path: _host_array(leaf) for path, leaf in tree_items(tree, prefix).items()}


def unflatten_to_like(flat: Dict[str, Any], like) -> Any:
    """Rebuild ``flat``'s leaves into the structure of ``like`` (paths must match)."""
    return _unflatten(flat, like, "")


def _unflatten(flat: Dict[str, Any], node, path: str) -> Any:
    if isinstance(node, dict):
        return {k: _unflatten(flat, v, f"{path}/{k}" if path else str(k))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)([_unflatten(flat, v, f"{path}/{i}" if path else str(i))
                           for i, v in enumerate(node)])
    if node is None:
        return None
    if path not in flat:
        sample = ", ".join(sorted(flat)[:4])
        raise KeyError(f"checkpoint missing array for {path!r} (stored keys look like: "
                       f"{sample or '<empty>'})")
    return flat[path]


def copy_into(tree, flat: Dict[str, np.ndarray], what: str) -> None:
    """Copy ``flat``'s arrays into the tensors of ``tree`` in place (on
    their device, in their dtype, without autograd history), so every
    holder of those tensors sees the restored values; raises on a missing
    or extra path or a shape mismatch before copying anything."""
    dst = tree_items(tree)
    missing, extra = sorted(set(dst) - set(flat)), sorted(set(flat) - set(dst))
    if missing or extra:
        raise KeyError(f"{what} paths differ: missing {missing}, extra {extra}")
    bad = [(p, tuple(flat[p].shape), tuple(t.shape)) for p, t in dst.items()
           if tuple(flat[p].shape) != tuple(t.shape)]
    if bad:
        raise ValueError(f"{what} shape mismatch (path, checkpoint, model): {bad}")
    with torch.no_grad():
        for path, t in dst.items():
            # ascontiguousarray returns at least 1-d: a 0-d leaf stays 0-d
            a = np.ascontiguousarray(flat[path]).reshape(np.shape(flat[path]))
            if not a.flags.writeable:  # torch.from_numpy takes writable arrays
                a = a.copy()
            src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if a.dtype == _BF16_RAW else torch.from_numpy(a))
            t.copy_(src)


class _HashingWriter:
    """Write-only file wrapper that sha256-hashes bytes as they pass through.

    Reports unseekable so zipfile streams with data descriptors instead of
    seeking back to patch local headers: every byte reaching the file goes
    through :meth:`write`, so the digest matches the file without a second
    read."""

    def __init__(self, f):
        self._f = f
        self._sha = hashlib.sha256()
        self.size = 0

    def write(self, data) -> int:
        self._sha.update(data)
        self.size += len(data)
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def seekable(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    def readable(self) -> bool:
        return False

    def read(self, *args):
        # numpy's zipfile_factory takes an object with .read for a file;
        # never called in mode 'w'
        raise OSError("write-only stream")

    def tell(self) -> int:
        return self.size

    def digest(self) -> Tuple[str, int]:
        return self._sha.hexdigest(), self.size


def _atomic_savez(path: str, flat: Dict[str, np.ndarray]) -> Tuple[str, int]:
    """Write ``flat`` as ``path`` through a temporary name; (sha256, size)."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        w = _HashingWriter(f)
        np.savez(w, **flat)
    os.replace(tmp, path)
    return w.digest()


def save_pytree(path: str, tree) -> Tuple[str, int]:
    return _atomic_savez(path, flatten_pytree(tree))


def load_pytree(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _checkpoint_files(step: int) -> Tuple[str, str, str]:
    return (f"model.{step}.npz", f"optimMethod.{step}.npz", f"state.{step}.json")


def file_digest(path: str) -> Tuple[str, int]:
    """(sha256 hexdigest, byte size) of a file."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            h.update(chunk)
    return h.hexdigest(), size


def _all_finite(flat: Dict[str, np.ndarray]) -> bool:
    return all(np.all(np.isfinite(a)) for a in flat.values()
               if np.issubdtype(a.dtype, np.floating))


def save_checkpoint(directory: str, step: int, params, optim_slots,
                    optim_state: Dict[str, Any], model_state=None,
                    keep_last: Optional[int] = None) -> Dict[str, Any]:
    """Write model.<step>.npz, optimMethod.<step>.npz and state.<step>.json,
    then the manifest (LAST); returns the manifest dict. ``keep_last=N``
    prunes all but the N newest checkpoints afterwards."""
    os.makedirs(directory, exist_ok=True)
    flat_model = flatten_pytree({"params": params, "model_state": model_state or {}})
    model_name, optim_name, state_name = _checkpoint_files(step)
    model_digest = _atomic_savez(os.path.join(directory, model_name), flat_model)
    host = {k: v for k, v in optim_state.items()
            if isinstance(v, (int, float, str, bool)) or v is None}
    host["_rng_seed"] = RandomGenerator.get_seed()
    host["_rng_counter"] = RandomGenerator._counter
    optim_digest = save_pytree(os.path.join(directory, optim_name), {"slots": optim_slots})
    state_path = os.path.join(directory, state_name)
    state_bytes = json.dumps(host).encode("utf-8")
    with open(state_path + ".tmp", "wb") as f:
        f.write(state_bytes)
    os.replace(state_path + ".tmp", state_path)
    state_digest = (hashlib.sha256(state_bytes).hexdigest(), len(state_bytes))
    manifest = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "finite": _all_finite(flat_model),
        "slot_layout": "tree",  # slots as per-leaf arrays, as the JAX package writes them
        "files": {name: {"sha256": sha, "bytes": size}
                  for name, (sha, size) in ((model_name, model_digest),
                                            (optim_name, optim_digest),
                                            (state_name, state_digest))},
    }
    mpath = os.path.join(directory, f"manifest.{step}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    if keep_last is not None:
        prune_checkpoints(directory, keep_last)
    return manifest


def checkpoint_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """The step's manifest dict, or None for a legacy/incomplete checkpoint."""
    path = os.path.join(directory, f"manifest.{step}.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint(directory: str, step: int) -> Optional[str]:
    """Re-hash the step's files against its manifest: None when they verify
    (or there is no manifest to check), else what does not match."""
    manifest = checkpoint_manifest(directory, step)
    if manifest is None:
        return None
    if manifest.get("kind") == FLEET_KIND:
        entries = {e.get("file", f"shard.p{k}.{step}.npz"): e
                   for k, e in manifest.get("shards", {}).items()}
    else:
        entries = manifest.get("files", {})
    for name, want in entries.items():
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            return f"{name} is missing"
        digest, size = file_digest(path)
        if size != want.get("bytes"):
            return f"{name} is {size} bytes, manifest says {want.get('bytes')} (truncated?)"
        if digest != want.get("sha256"):
            return f"{name} content checksum mismatch"
    return None


def _manifest_finite(directory: str, step: int) -> bool:
    """Manifest finiteness; a checkpoint without a manifest counts finite."""
    manifest = checkpoint_manifest(directory, step)
    return manifest is None or manifest.get("finite") is not False


def prune_checkpoints(directory: str, keep_last: int) -> List[int]:
    """Delete all but the ``keep_last`` newest complete checkpoints, always
    keeping the newest finite one; returns the pruned steps."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    steps = _checkpoint_steps(directory)
    doomed = steps[keep_last:]
    if doomed and not any(_manifest_finite(directory, s) for s in steps[:keep_last]):
        for s in doomed:
            if _manifest_finite(directory, s):
                doomed = [d for d in doomed if d != s]
                break
    for step in doomed:
        _remove_checkpoint(directory, step)
    return doomed


def quarantine_nonfinite(directory: str, newer_than: Optional[int] = None) -> List[int]:
    """Delete checkpoints whose manifest records non-finite params (only
    those with step > ``newer_than`` when given); returns the deleted steps."""
    doomed = [s for s in _checkpoint_steps(directory)
              if not _manifest_finite(directory, s) and (newer_than is None or s > newer_than)]
    for step in doomed:
        _remove_checkpoint(directory, step)
    return doomed


def _remove_checkpoint(directory: str, step: int) -> None:
    manifest = checkpoint_manifest(directory, step)
    if manifest is not None and manifest.get("kind") == FLEET_KIND:
        names = [e.get("file", f"shard.p{k}.{step}.npz")
                 for k, e in manifest.get("shards", {}).items()]
    else:
        names = list(_checkpoint_files(step))
    for name in (*names, f"manifest.{step}.json"):
        try:
            os.remove(os.path.join(directory, name))
        except OSError:  # already gone
            pass


def _checkpoint_steps(directory: str) -> List[int]:
    """Steps with a complete (model, optimMethod, state) triple or a fleet
    manifest (written last, so its presence marks the shards complete),
    newest first."""
    if not os.path.isdir(directory):
        return []
    steps = []
    names = os.listdir(directory)
    for name in names:
        if name.startswith("model.") and name.endswith(".npz"):
            try:
                step = int(name.split(".")[1])
            except ValueError:
                continue
            if all(os.path.exists(os.path.join(directory, f))
                   for f in _checkpoint_files(step)[1:]):
                steps.append(step)
    seen = set(steps)
    for name in names:
        if name.startswith("manifest.") and name.endswith(".json"):
            try:
                step = int(name.split(".")[1])
            except (IndexError, ValueError):
                continue
            if step not in seen and (checkpoint_manifest(directory, step) or {}).get(
                    "kind") == FLEET_KIND:
                steps.append(step)
                seen.add(step)
    return sorted(steps, reverse=True)


def latest_checkpoint_step(directory: str) -> Optional[int]:
    steps = _checkpoint_steps(directory)
    return steps[0] if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None, params_like=None,
                    min_generation: Optional[int] = None, require_finite: bool = False
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, Any],
                               Dict[str, np.ndarray]]:
    """``(params, optim_slots, host_state, model_state)``, the arrays as flat
    ``{path: array}`` dicts (:func:`unflatten_to_like` rebuilds a tree).

    With ``step=None``, complete checkpoints are tried newest-first: one
    that fails verification or fails to load is logged and skipped for the
    next older one (and a fleet checkpoint older than ``min_generation``
    too, and with ``require_finite`` one whose manifest records non-finite
    parameters: the divergence rollback's). An explicit ``step`` that fails
    verification raises :class:`CheckpointCorrupt`. A fleet checkpoint
    needs ``params_like`` (the model's parameter tree) to rebuild the tree
    from its vectors."""
    if step is None:
        candidates = _checkpoint_steps(directory)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        last_err: Optional[Exception] = None
        for cand in candidates:
            if require_finite and not _manifest_finite(directory, cand):
                log.warning("checkpoint step %d holds non-finite params; skipping for the "
                            "divergence rollback", cand)
                continue
            if min_generation is not None:
                m = checkpoint_manifest(directory, cand) or {}
                if m.get("kind") == FLEET_KIND and int(m.get("generation", 0)) < min_generation:
                    log.warning("fleet checkpoint step %d has stale generation %s < %s; "
                                "skipping", cand, m.get("generation"), min_generation)
                    continue
            try:
                return load_checkpoint(directory, cand, params_like)
            except (OSError, ValueError, KeyError, RuntimeError) as e:
                log.warning("checkpoint step %d failed to load (%s); falling back to the "
                            "newest verified older checkpoint", cand, e)
                last_err = e
        if last_err is None:
            raise FileNotFoundError(f"no loadable checkpoint under {directory}")
        raise last_err
    manifest = checkpoint_manifest(directory, step)
    is_fleet = manifest is not None and manifest.get("kind") == FLEET_KIND
    if (is_fleet and min_generation is not None
            and int(manifest.get("generation", 0)) < int(min_generation)):
        raise ArtifactIncompatible(
            os.path.join(directory, f"manifest.{step}.json"),
            f"stale fleet generation {manifest.get('generation')} < {min_generation} "
            "(written before the last remesh)")
    detail = verify_checkpoint(directory, step)
    if detail is not None:
        raise CheckpointCorrupt(directory, step, detail)
    if is_fleet:
        return _load_fleet_as_trees(directory, step, params_like)
    model_blob = load_pytree(os.path.join(directory, f"model.{step}.npz"))
    slots_blob = load_pytree(os.path.join(directory, f"optimMethod.{step}.npz"))
    with open(os.path.join(directory, f"state.{step}.json")) as f:
        host = json.load(f)
    params = {k[len("params/"):]: v for k, v in model_blob.items() if k.startswith("params/")}
    model_state = {k[len("model_state/"):]: v for k, v in model_blob.items()
                   if k.startswith("model_state/")}
    slots = {k[len("slots/"):]: v for k, v in slots_blob.items()}
    return params, slots, host, model_state


# ---------------------------------------------------------------------------
# fleet checkpoints (the JAX package's per-host-sharded format)
# ---------------------------------------------------------------------------

def fleet_shard_file(step: int, index: int) -> str:
    return f"shard.p{int(index)}.{int(step)}.npz"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else str(
        np.dtype(dtype))


def fleet_codec_info(fp) -> Dict[str, Any]:
    """A ``FlatParameter`` 's geometry for the fleet manifest: the shard
    arithmetic and a sha256 over its (path, shape, dtype) leaf table, as the
    JAX package writes it."""
    blob = json.dumps([[p, [int(x) for x in s], _dtype_name(d)]
                       for p, s, d in zip(fp.paths, fp.shapes, fp.dtypes)]).encode("utf-8")
    return {"total": int(fp.total), "padded_total": int(fp.padded_total),
            "shard_size": int(fp.shard_size), "n_shards": int(fp.n_shards),
            "paths_sha256": hashlib.sha256(blob).hexdigest()}


def save_fleet_shard(directory: str, step: int, index: int, *, lo: int, hi: int, master_slice,
                     slot_slices: Optional[Dict[str, Any]] = None,
                     scalars: Optional[Dict[str, Any]] = None,
                     model_state_flat: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write process ``index`` 's ``shard.p<k>.<step>.npz``: its ``[lo, hi)``
    slice of the master and of each flat slot vector; scalar slot state and
    the model state whole. Returns the manifest's entry for it."""
    os.makedirs(directory, exist_ok=True)
    lo, hi = int(lo), int(hi)
    master_slice = _host_array(master_slice)
    if master_slice.shape != (hi - lo,):
        raise ValueError(f"shard p{index} master slice has shape {master_slice.shape}; "
                         f"bounds [{lo}, {hi}) want ({hi - lo},)")
    flat: Dict[str, np.ndarray] = {"master": master_slice.astype(np.float32, copy=False),
                                   "_lo": np.asarray(lo, np.int64),
                                   "_hi": np.asarray(hi, np.int64)}
    finite = bool(np.all(np.isfinite(flat["master"])))
    for name, piece in (slot_slices or {}).items():
        piece = _host_array(piece)
        if piece.shape != (hi - lo,):
            raise ValueError(f"shard p{index} slot {name!r} slice has shape {piece.shape}; "
                             f"bounds [{lo}, {hi}) want ({hi - lo},)")
        flat[f"slot/{name}"] = piece
    for name, v in (scalars or {}).items():
        flat[f"scalar/{name}"] = _host_array(v)
    for path, v in (model_state_flat or {}).items():
        a = _host_array(v)
        flat[f"model_state/{path}"] = a
        if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
            finite = False
    name = fleet_shard_file(step, index)
    sha, size = _atomic_savez(os.path.join(directory, name), flat)
    return {"file": name, "sha256": sha, "bytes": int(size), "lo": lo, "hi": hi,
            "finite": finite}


def save_fleet_manifest(directory: str, step: int, shards: Dict[int, Dict[str, Any]], *,
                        codec: Dict[str, Any], mesh_shape, process_count: int,
                        optim_state: Optional[Dict[str, Any]] = None, generation: int = 0,
                        keep_last: Optional[int] = None) -> Dict[str, Any]:
    """Write the fleet ``manifest.<step>.json`` LAST; the shards' bounds
    must tile ``[0, padded_total)``."""
    padded = int(codec["padded_total"])
    pos = 0
    for s_lo, s_hi in sorted((int(e["lo"]), int(e["hi"])) for e in shards.values()):
        if s_lo != pos:
            raise ValueError(f"fleet shard bounds leave a gap at offset {pos} "
                             f"(next shard starts at {s_lo})")
        pos = s_hi
    if pos != padded:
        raise ValueError(f"fleet shards cover [0, {pos}) of padded_total {padded}")
    host = {k: v for k, v in (optim_state or {}).items()
            if isinstance(v, (int, float, str, bool)) or v is None}
    host["_rng_seed"] = RandomGenerator.get_seed()
    host["_rng_counter"] = RandomGenerator._counter
    manifest = {
        "format": MANIFEST_FORMAT, "kind": FLEET_KIND, "step": int(step),
        "generation": int(generation),
        "finite": all(e.get("finite", True) for e in shards.values()),
        "process_count": int(process_count), "mesh": {"shape": [int(s) for s in mesh_shape]},
        "codec": dict(codec), "slot_layout": "fleet", "host": host,
        "shards": {str(int(k)): dict(e) for k, e in shards.items()},
    }
    mpath = os.path.join(directory, f"manifest.{step}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    if keep_last is not None:
        prune_checkpoints(directory, keep_last)
    return manifest


def save_fleet_checkpoint(directory: str, step: int, *, master, slots: Dict[str, Any],
                          bounds: Dict[int, Tuple[int, int]], codec: Dict[str, Any],
                          mesh_shape, process_count: int,
                          optim_state: Optional[Dict[str, Any]] = None, model_state=None,
                          generation: int = 0,
                          keep_last: Optional[int] = None) -> Dict[str, Any]:
    """Split the full padded master and flat slot vectors into the
    processes' ``bounds``, write every shard, then the manifest."""
    master = _host_array(master)
    padded = int(codec["padded_total"])
    if master.shape != (padded,):
        raise ValueError(f"master vector has shape {master.shape}, codec says ({padded},)")
    vec_slots: Dict[str, np.ndarray] = {}
    scalars: Dict[str, np.ndarray] = {}
    for name, v in (slots or {}).items():
        a = _host_array(v)
        (vec_slots if a.shape == (padded,) else scalars)[name] = a
    ms_flat = flatten_pytree(model_state or {})
    entries = {int(k): save_fleet_shard(
        directory, step, int(k), lo=int(lo), hi=int(hi), master_slice=master[int(lo):int(hi)],
        slot_slices={n: a[int(lo):int(hi)] for n, a in vec_slots.items()}, scalars=scalars,
        model_state_flat=ms_flat) for k, (lo, hi) in bounds.items()}
    return save_fleet_manifest(directory, step, entries, codec=codec, mesh_shape=mesh_shape,
                               process_count=process_count, optim_state=optim_state,
                               generation=generation, keep_last=keep_last)


def load_fleet_shards(directory: str, step: int, indices=None, verify: bool = True
                      ) -> Tuple[Dict[str, Any], Dict[int, Dict[str, Any]]]:
    """Verify and read any subset of a fleet checkpoint's shards:
    ``(manifest, {index: {"lo", "hi", "master", "slots", "scalars",
    "model_state"}})``; a missing or tampered shard is
    :class:`CheckpointCorrupt`."""
    manifest = checkpoint_manifest(directory, step)
    if manifest is None or manifest.get("kind") != FLEET_KIND:
        raise CheckpointCorrupt(directory, step, "no fleet manifest")
    entries = manifest.get("shards", {})
    if indices is None:
        indices = sorted(int(k) for k in entries)
    out: Dict[int, Dict[str, Any]] = {}
    for k in indices:
        e = entries.get(str(int(k)))
        if e is None:
            raise CheckpointCorrupt(directory, step, f"manifest lists no shard p{int(k)}")
        path = os.path.join(directory, e["file"])
        if not os.path.exists(path):
            raise CheckpointCorrupt(directory, step, f"{e['file']} is missing")
        if verify:
            sha, size = file_digest(path)
            if size != e.get("bytes"):
                raise CheckpointCorrupt(directory, step, f"{e['file']} is {size} bytes, "
                                        f"manifest says {e.get('bytes')} (truncated?)")
            if sha != e.get("sha256"):
                raise CheckpointCorrupt(directory, step, f"{e['file']} content checksum mismatch")
        blob = load_pytree(path)

        def part(prefix):
            return {kk[len(prefix):]: v for kk, v in blob.items() if kk.startswith(prefix)}

        out[int(k)] = {"lo": int(e["lo"]), "hi": int(e["hi"]), "master": blob["master"],
                       "slots": part("slot/"), "scalars": part("scalar/"),
                       "model_state": part("model_state/")}
    return manifest, out


def load_fleet_checkpoint(directory: str, step: Optional[int] = None, verify: bool = True):
    """The full padded master and flat slot vectors of a fleet checkpoint:
    ``(master, slot_vectors, scalars, host, model_state_flat, manifest)``;
    ``step=None`` is the newest fleet step. A coverage gap is
    :class:`CheckpointCorrupt`."""
    if step is None:
        steps = [s for s in _checkpoint_steps(directory)
                 if (checkpoint_manifest(directory, s) or {}).get("kind") == FLEET_KIND]
        if not steps:
            raise FileNotFoundError(f"no fleet checkpoints under {directory}")
        step = steps[0]
    manifest, shards = load_fleet_shards(directory, step, verify=verify)
    padded = int(manifest["codec"]["padded_total"])
    pieces = sorted(shards.values(), key=lambda d: d["lo"])
    pos = 0
    for p in pieces:
        if p["lo"] != pos:
            raise CheckpointCorrupt(directory, step, f"shard coverage gap at offset {pos} "
                                    f"(next shard starts at {p['lo']})")
        pos = p["hi"]
    if pos != padded:
        raise CheckpointCorrupt(directory, step, f"shards cover [0, {pos}) of padded_total "
                                f"{padded}")
    master = np.concatenate([p["master"] for p in pieces])
    slots: Dict[str, np.ndarray] = {}
    for name in sorted({n for p in pieces for n in p["slots"]}):
        segs = []
        for p in pieces:
            if name not in p["slots"]:
                raise CheckpointCorrupt(directory, step, f"slot {name!r} missing from the shard "
                                        f"covering [{p['lo']}, {p['hi']})")
            segs.append(p["slots"][name])
        slots[name] = np.concatenate(segs)
    first = pieces[0]
    return (master, slots, dict(first["scalars"]), dict(manifest.get("host", {})),
            dict(first["model_state"]), manifest)


def _load_fleet_as_trees(directory: str, step: int, params_like):
    """A fleet checkpoint -> :func:`load_checkpoint` 's flat dicts: the full
    vectors assembled (already verified), the codec checked against
    ``params_like`` 's and decoded through it."""
    from ..parallel.parameter import FlatParameter

    if params_like is None:
        raise ValueError(f"fleet checkpoint step {step} under {directory} needs params_like "
                         "to rebuild the tree from the flat master vector")
    master, slot_vecs, scalars, host, ms_flat, manifest = load_fleet_checkpoint(
        directory, step, verify=False)
    codec = manifest.get("codec", {})
    fp = FlatParameter(params_like, max(1, int(codec.get("n_shards", 1))))
    got = fleet_codec_info(fp)
    for key in ("total", "padded_total", "shard_size", "n_shards", "paths_sha256"):
        if got.get(key) != codec.get(key):
            raise ArtifactIncompatible(
                os.path.join(directory, f"manifest.{step}.json"),
                f"codec geometry mismatch on {key!r}: checkpoint has {codec.get(key)}, this "
                f"model wants {got.get(key)} — fleet shards only assemble onto the exact model "
                "they were sliced from")
    params = flatten_pytree(fp.unflatten(torch.from_numpy(np.ascontiguousarray(master))))
    tree_slots: Dict[str, Any] = fp.slots_tree_view(
        {name: torch.from_numpy(np.ascontiguousarray(v)) for name, v in slot_vecs.items()})
    tree_slots.update(scalars)
    return params, flatten_pytree(tree_slots), host, ms_flat
