"""Artifact bundles: what a replica or a resumed trainer needs to start
without building anything (counterpart of ``bigdl_tpu/utils/aot.py``).

What stands for ``jax.export`` here. The port compiles no per-shape
program: it runs eagerly, and its one compiled artifact is the kernel
library, ``libbigdl_tpu_torch.so``, built by ``nvcc`` at the first kernel
launch of a process (``ops/_build.py``) into the compile-cache directory
(``BIGDL_COMPILE_CACHE_DIR``, default ``build/kernels``) beside the hash of
the sources it was built from. The cold half of a boot is that build, so a
bundle carries the library instead of serialized programs:

    <bundle>/
      cache/            the library and its source-hash stamp, harvested
                        from the exporting process's cache directory. A
                        process seeded from it loads the library at its
                        first kernel launch instead of running nvcc; the
                        load still probes the library and raises if the
                        probe fails, as for a built one.
      modules/<name>.json
                        one signature per (model, version, bucket) for
                        serving (``serving/artifacts.py``): the (shape,
                        dtype) of every parameter and state leaf under its
                        JAX parameter path, then the input's, then the
                        outputs' from one forward on the meta device. A
                        registration is held against it: the architecture
                        drift check of the JAX bundle's modules.
      manifest.json     written last: its presence marks the bundle
                        complete. The sha256 and size of every file, the
                        bucket geometry, and the environment fingerprint
                        (torch and CUDA versions, device name and compute
                        capability, local device count, the kernel sources'
                        hash, the fused-kernel switch, the compute and
                        activation dtypes).

The bundle holds no weights, as the JAX bundle holds none: a registering
model brings its own. Warmup still runs one forward per bucket, since the
cuBLAS/cuDNN handles and the allocator warm only by running; its
``fresh_compiles`` counts ``nvcc`` builds (1 on a cold boot, 0 on a warm
one).

Verify-on-load: :func:`load_bundle` hashes every file against the manifest
and checks the fingerprint; any mismatch raises the typed
:class:`ArtifactIncompatible`, which the serving layer turns into a cold
boot with a ``warn`` record. Only ``json`` and file copies touch bundle
bytes; nothing is unpickled.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .serialization import file_digest

log = logging.getLogger("bigdl_tpu_torch.utils.aot")

ARTIFACT_FORMAT = 1
MANIFEST = "manifest.json"

__all__ = ["ARTIFACT_FORMAT", "ArtifactIncompatible", "BundleWriter", "ExportedSignature",
           "TensorSpec", "check_fingerprint", "environment_fingerprint", "export_step_bundle",
           "load_bundle", "load_exported", "seed_from_bundle", "spec_tree", "warm_start"]


class ArtifactIncompatible(Exception):
    """A bundle this process cannot use: a corrupt or truncated payload, an
    environment mismatch, or geometry or architecture drift between the
    bundle and the registering model. ``reason`` says which."""

    def __init__(self, bundle: str, reason: str):
        self.bundle = bundle
        self.reason = reason
        super().__init__(f"artifact bundle {bundle}: {reason}")


class TensorSpec(NamedTuple):
    """Shape and dtype of one tensor (the ``ShapeDtypeStruct`` of the JAX
    package); ``dtype`` is the name without ``torch.``."""

    shape: Tuple[int, ...]
    dtype: str


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def spec_tree(args):
    """``args`` (nested dicts, lists and tuples of tensors) with each tensor
    replaced by its :class:`TensorSpec`: metadata only."""
    if isinstance(args, TensorSpec):
        return args
    if isinstance(args, dict):
        return {k: spec_tree(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(spec_tree(v) for v in args)
    if isinstance(args, torch.Tensor):
        return TensorSpec(tuple(args.shape), dtype_name(args.dtype))
    return args


def spec_leaves(tree, prefix: str = "") -> List[Tuple[str, TensorSpec]]:
    """``(path, spec)`` of every tensor or :class:`TensorSpec` of ``tree``
    in the JAX package's leaf order (dict keys sorted, sequences in order),
    paths as ``a/b/c``."""
    out: List[Tuple[str, TensorSpec]] = []
    _walk_specs(tree, prefix, out)
    return out


def _walk_specs(node, path: str, out: List[Tuple[str, TensorSpec]]) -> None:
    if isinstance(node, TensorSpec):
        out.append((path, node))
    elif isinstance(node, torch.Tensor):
        out.append((path, TensorSpec(tuple(node.shape), dtype_name(node.dtype))))
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk_specs(node[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk_specs(v, f"{path}/{i}" if path else str(i), out)


# --------------------------------------------------------------- fingerprint
def environment_fingerprint() -> Dict[str, Any]:
    """What must match between the exporting and the loading process for the
    bundle's library to be the one this process would build."""
    from ..ops import _build
    from .engine import Engine

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "cuda" if cuda else "cpu",
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "compute_capability": list(torch.cuda.get_device_capability(0)) if cuda else None,
        "local_devices": torch.cuda.device_count() if cuda else 0,
        "kernel_sources": _build.source_hash(),
        "fused_kernels": bool(Engine.fused_kernels()),
        "compute_dtype": Engine.compute_dtype(),
        "activation_dtype": Engine.activation_dtype(),
    }


def check_fingerprint(bundle: str, manifest: Dict[str, Any]) -> None:
    """Raise :class:`ArtifactIncompatible` when the bundle's fingerprint
    differs from this process's."""
    want = manifest.get("fingerprint")
    if not isinstance(want, dict):
        raise ArtifactIncompatible(bundle, "manifest carries no fingerprint")
    for key, have_val in environment_fingerprint().items():
        want_val = want.get(key)
        if want_val != have_val:
            raise ArtifactIncompatible(
                bundle, f"environment fingerprint mismatch on {key!r}: bundle has "
                        f"{want_val!r}, this process has {have_val!r}")


# -------------------------------------------------------------------- write
class BundleWriter:
    """Stages a bundle's files, then writes the manifest last::

        w = BundleWriter(path, kind="serving")
        w.add_module("m.v1.bfixed", signature)  # -> modules/m.v1.bfixed.json
        w.harvest_cache()                        # the library -> cache/
        manifest = w.commit(models={...})        # hashes + manifest.json

    An export that dies before ``commit`` leaves no ``manifest.json``, and
    loaders take the bundle as absent."""

    def __init__(self, path: str, *, kind: str):
        self.path = path
        self.kind = kind
        self._files: Dict[str, Tuple[str, int]] = {}
        self.cache_entries = 0
        os.makedirs(os.path.join(path, "modules"), exist_ok=True)
        # an earlier bundle at this path must not leak files into this one:
        # its completeness marker goes first, then its staged files
        try:
            os.remove(os.path.join(path, MANIFEST))
        except OSError:
            pass
        for sub in ("modules", "cache"):
            d = os.path.join(path, sub)
            if os.path.isdir(d):
                for name in os.listdir(d):
                    try:
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass

    def add_module(self, name: str, signature: Dict[str, Any]) -> str:
        rel = os.path.join("modules", f"{name}.json")
        full = os.path.join(self.path, rel)
        with open(full + ".tmp", "w") as f:
            json.dump(signature, f, indent=1)
        os.replace(full + ".tmp", full)
        self._files[rel] = file_digest(full)
        return rel

    def harvest_cache(self) -> int:
        """Copy the library and its stamp from the active cache directory;
        0 where nothing is built (recorded as such)."""
        from .compat import harvest_compile_cache

        dest = os.path.join(self.path, "cache")
        self.cache_entries = harvest_compile_cache(dest)
        if os.path.isdir(dest):
            for name in os.listdir(dest):
                rel = os.path.join("cache", name)
                self._files[rel] = file_digest(os.path.join(self.path, rel))
        return self.cache_entries

    def commit(self, **meta) -> Dict[str, Any]:
        manifest: Dict[str, Any] = {
            "format": ARTIFACT_FORMAT,
            "kind": self.kind,
            "created": time.time(),
            "fingerprint": environment_fingerprint(),
            "cache_entries": self.cache_entries,
        }
        manifest.update(meta)
        manifest["files"] = {rel: {"sha256": sha, "bytes": size}
                             for rel, (sha, size) in sorted(self._files.items())}
        mpath = os.path.join(self.path, MANIFEST)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(mpath + ".tmp", mpath)
        return manifest


# --------------------------------------------------------------------- load
def _verify_file(path: str, rel: str, want: Dict[str, Any]) -> None:
    full = os.path.join(path, rel)
    if not os.path.exists(full):
        raise ArtifactIncompatible(path, f"{rel} is missing")
    try:
        sha, size = file_digest(full)
    except OSError as e:  # an I/O fault is the bundle's problem: typed
        raise ArtifactIncompatible(path, f"{rel} unreadable: {e}")
    if size != want.get("bytes"):
        raise ArtifactIncompatible(
            path, f"{rel} is {size} bytes, manifest says {want.get('bytes')} (truncated?)")
    if sha != want.get("sha256"):
        raise ArtifactIncompatible(path, f"{rel} content checksum mismatch")


def load_bundle(path: str, *, check_env: bool = True) -> Dict[str, Any]:
    """The verified loader: the manifest, its format, every file's sha256
    and size, and (by default) the fingerprint. Returns the manifest; every
    failure raises :class:`ArtifactIncompatible`."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isdir(path):
        raise ArtifactIncompatible(path, "bundle directory does not exist")
    if not os.path.exists(mpath):
        raise ArtifactIncompatible(path, "manifest.json missing (incomplete or interrupted "
                                         "export)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactIncompatible(path, f"manifest.json unreadable: {e}")
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ArtifactIncompatible(path, f"manifest format {manifest.get('format')!r} != "
                                         f"supported {ARTIFACT_FORMAT}")
    for rel, want in manifest.get("files", {}).items():
        _verify_file(path, rel, want)
    if check_env:
        check_fingerprint(path, manifest)
    return manifest


class ExportedSignature:
    """One module of a bundle: the ``in_avals`` (parameter and state leaves,
    then the input) and ``out_avals`` as :class:`TensorSpec`, with their
    paths; the counterpart of a deserialized ``jax.export.Exported``."""

    def __init__(self, signature: Dict[str, Any]):
        def specs(rows):
            return [TensorSpec(tuple(r["shape"]), r["dtype"]) for r in rows]

        self.in_paths = [r["path"] for r in signature["inputs"]]
        self.in_avals = specs(signature["inputs"])
        self.out_paths = [r["path"] for r in signature["outputs"]]
        self.out_avals = specs(signature["outputs"])


def load_exported(path: str, rel: str, manifest: Dict[str, Any]) -> ExportedSignature:
    """Read one manifest-listed module after verifying its hash again (a
    bundle changed after :func:`load_bundle` is caught here)."""
    want = manifest.get("files", {}).get(rel)
    if want is None:
        raise ArtifactIncompatible(path, f"{rel} not listed in manifest")
    _verify_file(path, rel, want)
    try:
        with open(os.path.join(path, rel)) as f:
            return ExportedSignature(json.load(f))
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ArtifactIncompatible(path, f"{rel} failed to load: {e}")


def signature_rows(leaves: List[Tuple[str, TensorSpec]]) -> List[Dict[str, Any]]:
    return [{"path": p, "shape": list(s.shape), "dtype": s.dtype} for p, s in leaves]


# -------------------------------------------------------------------- seed
def seed_from_bundle(path: str, manifest: Optional[Dict[str, Any]] = None) -> int:
    """Copy the bundle's library into this process's configured cache
    directory, so the first kernel launch loads it instead of building;
    returns the files copied. Refuses (typed) when no directory is
    configured."""
    from .compat import seed_compile_cache
    from .engine import Engine

    if manifest is None:
        manifest = load_bundle(path)
    src = os.path.join(path, "cache")
    if not os.path.isdir(src):
        return 0
    if Engine.ensure_compilation_cache() is None:
        raise ArtifactIncompatible(
            path, "no persistent compile cache configured on this host; set "
                  "BIGDL_COMPILE_CACHE_DIR before warm-starting")
    try:
        return seed_compile_cache(src)
    except OSError as e:  # disk full, permissions: typed, degradable
        raise ArtifactIncompatible(path, f"cache seeding failed: {e}")


def warm_start(path: str, kind: Optional[str] = None) -> Dict[str, Any]:
    """Verify a bundle and seed this process's cache directory from it;
    returns the manifest. ``kind`` rejects the other flavour of bundle
    before anything is seeded. Raises :class:`ArtifactIncompatible`."""
    manifest = load_bundle(path)
    if kind is not None and manifest.get("kind") != kind:
        raise ArtifactIncompatible(
            path, f"bundle kind {manifest.get('kind')!r} is not a {kind!r} bundle")
    n = seed_from_bundle(path, manifest)
    log.info("warm start from %s: %d cache file(s) seeded, kind=%s", path, n,
             manifest.get("kind"))
    return manifest


# ----------------------------------------------------------- trainer bundle
EAGER_EXPORT_ERROR = ("the port runs eager: there is no compiled train-step program to "
                      "serialize; the bundle's kernel library is what a resume loads "
                      "instead of building")


def export_step_bundle(path: str, *, fn=None, specs, path_type: str,
                       extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trainer bundle: the cache harvest and the manifest, whose ``step``
    records the step's argument specs (``specs``: a tree of tensors or
    :class:`TensorSpec`). ``fn`` (the JAX package's jitted step) has no
    counterpart to serialize, so ``module`` is None and ``export_error``
    says why."""
    w = BundleWriter(path, kind="train_step")
    w.harvest_cache()
    return w.commit(step={
        "path_type": path_type,
        "module": None,
        "export_error": EAGER_EXPORT_ERROR,
        "arg_specs": [{"shape": list(s.shape), "dtype": s.dtype}
                      for _, s in spec_leaves(specs)],
        **(extra or {}),
    })
