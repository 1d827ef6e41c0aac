"""Serving's artifact bundles (counterpart of ``bigdl_tpu/serving/artifacts.py``).

``ModelServer.export_artifacts(path)`` comes here: one module per (model,
version, bucket), the geometry the server's warmup drives, plus the kernel
library harvested from the cache directory and the manifest
(``utils/aot.py`` writes and verifies the bundle; this module owns what the
modules are, the geometry contract, and installing them on a Predictor).

A module is a signature, not a program (``utils/aot.py`` says why): the
(shape, dtype) of every parameter and state leaf of the model under its JAX
path, then the padded input's, then the outputs of one forward on the meta
device. A registration whose model does not give the same inputs is
refused with :class:`~bigdl_tpu_torch.utils.aot.ArtifactIncompatible`: the
record-level check (:func:`check_geometry`) cannot see an architecture that
changed under the same record shape (a wider layer, an int8 twin), and
this one can.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..optim.predictor import Predictor
from ..utils import aot

log = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["check_geometry", "export_server_artifacts", "install_modules", "model_entry"]


def _bucket_shapes(batch_size: int, sample: np.ndarray,
                   shape_buckets: Optional[Sequence[int]]) -> Dict[str, Tuple[int, ...]]:
    """tag -> the full padded input shape of each geometry: the bucket
    boundaries when bucketed, else the one fixed batch shape."""
    if shape_buckets:
        return {str(b): (batch_size, int(b)) + tuple(sample.shape[1:]) for b in shape_buckets}
    return {"fixed": (batch_size,) + tuple(sample.shape)}


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(1, np.dtype(dtype))).dtype


def _input_leaves(model, x_spec: aot.TensorSpec) -> List[Tuple[str, aot.TensorSpec]]:
    """The registering model's inputs of the padded forward: parameter and
    state leaves, then the input."""
    return (aot.spec_leaves(model.get_parameters(), "params")
            + aot.spec_leaves(model.get_state(), "state") + [("x", x_spec)])


def module_signature(model, shape: Tuple[int, ...], dtype, capture_state: bool) -> Dict[str, Any]:
    """The module of one geometry: the inputs, and the outputs of one eval
    forward on the meta device (the new state's too with ``capture_state``,
    as the predictor returns it)."""
    from ..nn.module import _map_tree, _meta_like, import_torch_dynamo

    x_spec = aot.TensorSpec(tuple(shape), aot.dtype_name(_torch_dtype(dtype)))
    import_torch_dynamo()
    with torch.no_grad():
        y, new_state = model._apply_params(
            _map_tree(_meta_like, model.get_parameters()),
            _map_tree(_meta_like, model.get_state()),
            torch.empty(shape, dtype=_torch_dtype(dtype), device="meta"), False, None)
    outputs = aot.spec_leaves(y, "y")
    if capture_state:
        outputs += aot.spec_leaves(new_state, "state")
    return {"inputs": aot.signature_rows(_input_leaves(model, x_spec)),
            "outputs": aot.signature_rows(outputs)}


def export_server_artifacts(server, path: str) -> Dict[str, Any]:
    """Write the bundle of every registered model; returns the manifest.
    Serving goes on meanwhile: only the management lock is held (by the
    caller, ``ModelServer.export_artifacts``)."""
    entries = server._export_entries()
    if not entries:
        raise ValueError("export_artifacts: no models registered")
    w = aot.BundleWriter(path, kind="serving")
    models: Dict[str, Any] = {}
    for e in entries:
        if e.sample is None:
            log.warning("export_artifacts: model %r was registered without sample_input: "
                        "no input geometry to export; a warm boot registers it cold", e.name)
            continue
        predictor = e.predictor
        modules: Dict[str, str] = {}
        for tag, shape in _bucket_shapes(predictor.batch_size, e.sample,
                                         e.shape_buckets).items():
            sig = module_signature(e.model, shape, e.sample.dtype, e.drift is not None)
            modules[tag] = w.add_module(f"{e.name}.v{e.version}.b{tag}", sig)
        models[e.name] = {
            "version": int(e.version),
            "batch_size": int(predictor.batch_size),
            "shape_buckets": list(e.shape_buckets) if e.shape_buckets else None,
            "record_trailing": (list(e.sample.shape[1:]) if e.shape_buckets
                                else list(e.sample.shape)),
            "record_dtype": str(e.sample.dtype),
            "capture_state": e.drift is not None,
            "quantized": bool(e.quantized),
            "modules": modules,
        }
    w.harvest_cache()
    manifest = w.commit(models=models)
    log.info("exported serving artifacts to %s: %d model(s), %d module(s), %d cache file(s)",
             path, len(models), sum(len(m["modules"]) for m in models.values()),
             manifest["cache_entries"])
    return manifest


def model_entry(bundle: str, manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    entry = manifest.get("models", {}).get(name)
    if entry is None:
        raise aot.ArtifactIncompatible(
            bundle, f"no artifacts for model {name!r} (bundle carries "
                    f"{sorted(manifest.get('models', {}))})")
    return entry


def check_geometry(bundle: str, entry: Dict[str, Any], name: str, *, batch_size: int,
                   shape_buckets: Optional[Sequence[int]], sample: np.ndarray,
                   capture_state: bool) -> None:
    """Raise :class:`~bigdl_tpu_torch.utils.aot.ArtifactIncompatible` unless
    the registration's geometry (bucket boundaries, batch size, record shape
    and dtype, whether the state is captured) is the bundle's."""
    want_buckets = list(shape_buckets) if shape_buckets else None
    record = list(sample.shape[1:]) if shape_buckets else list(sample.shape)
    for field, have in (("batch_size", int(batch_size)), ("shape_buckets", want_buckets),
                        ("record_trailing", record), ("record_dtype", str(sample.dtype)),
                        ("capture_state", bool(capture_state))):
        if entry.get(field) != have:
            raise aot.ArtifactIncompatible(
                bundle, f"model {name!r} geometry drift on {field!r}: bundle has "
                        f"{entry.get(field)!r}, registration wants {have!r}")


def install_modules(bundle: str, manifest: Dict[str, Any], entry: Dict[str, Any],
                    predictor: Predictor, sample: np.ndarray,
                    shape_buckets: Optional[Sequence[int]]) -> int:
    """Read every module of one model's entry (each hash verified again),
    hold the registering model's inputs against it, and record each covered
    geometry on the predictor's seam; returns how many. All or nothing: one
    bad module refuses the whole entry."""
    installed = []
    for tag, rel in entry.get("modules", {}).items():
        exported = aot.load_exported(bundle, rel, manifest)
        if tag == "fixed":
            shape = (entry["batch_size"],) + tuple(sample.shape)
        else:
            shape = (entry["batch_size"], int(tag)) + tuple(sample.shape[1:])
        x_spec = aot.TensorSpec(shape, aot.dtype_name(_torch_dtype(entry["record_dtype"])))
        want = [(p, tuple(s.shape), s.dtype) for p, s in _input_leaves(predictor.model, x_spec)]
        have = [(p, tuple(s.shape), s.dtype) for p, s in zip(exported.in_paths, exported.in_avals)]
        if want != have:
            raise aot.ArtifactIncompatible(
                bundle, f"module {rel} was exported for a different model architecture "
                        f"({len(have)} input leaves vs the registration's {len(want)}, or "
                        "shape/dtype drift): params/state signature mismatch")
        installed.append((Predictor.aot_key(x_spec), exported))
    for key, exported in installed:
        predictor.install_aot_call(key, exported)
    return len(installed)
