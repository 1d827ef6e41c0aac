#!/usr/bin/env python
"""Whole-program AST concurrency auditor for the port's threaded runtime
(counterpart of ``bigdl_tpu/analysis/concurrency.py``).

The serving, pipeline and observability tier of ``bigdl_tpu_torch`` is
multi-threaded: the ``ContinuousBatcher`` worker (``spawn_worker``), the
``ServingSupervisor`` and the ``MonitorBase`` poll loops (``StallWatchdog``,
``FleetMonitor``), the ``ObsEndpoint`` HTTP scrape threads, the
``DataPipeline`` feeder and decode workers and the prefetch seam. This
module machine-checks their lock discipline with four passes that never
import (let alone run) the audited code:

1. **Thread-entry mapping** — resolve which functions run on which thread by
   tracing the spawn seams (``spawn_worker(target)``,
   ``threading.Thread(target=...)``, ``MonitorBase`` subclasses' ``check()``
   poll entries, ``http.server`` ``do_*`` handlers), then propagate the
   thread tags over the static call graph (``self.method()`` calls,
   attribute-typed calls like ``self.queue.pop()``, module-level calls).
   ``--entry-map`` prints the result.
2. **Lock-discipline inference (BDL017)** — per class, the guarded-attribute
   set comes from ``# guarded-by: _lock`` annotations (on the ``__init__``
   assignment line, an annotated assignment such as
   ``self._cbs: List[F] = []`` included, which the JAX auditor skips) plus
   usage inference (every non-``__init__`` write of the
   attribute happens under one common lock). Any read/write of a guarded
   attribute from a function reachable by a *different* thread than some
   other accessor, without the lock held, is flagged. Deliberate unlocked
   reads carry a ``# lint: disable=BDL017`` suppression with the invariant
   stated.
3. **Wait/notify + blocking-call discipline (BDL018)** — ``Condition.wait``
   must sit inside a ``while``-predicate loop with its condition held,
   ``notify``/``notify_all`` must hold the condition, and known-blocking
   calls are banned inside ``with`` blocks of locks annotated
   ``# hot-lock`` (the batcher's dispatch lock, the server's locks, the
   request queue's lock): one blocked holder stalls every thread that needs
   the lock. The blocking calls are ``join``, ``Future.result`` with no
   timeout, blocking ``Queue.get/put``, ``sleep``, socket/HTTP calls, and
   the forms that wait for the card (a host copy of a CUDA tensor
   synchronises the stream): ``.item()``, ``.tolist()``, ``.cpu()``,
   ``.numpy()``, ``torch.cuda.synchronize()`` and any ``.synchronize()``
   (a stream's or an event's), and ``np.asarray``/``np.array`` (which copy
   a CUDA tensor to the host through ``__array__``). The JAX auditor bans
   JAX's forms of the same thing (``.block_until_ready()``,
   ``device_get``); those do not occur in the port.
4. **Lock-order graph (BDL019)** — every statically visible nested
   acquisition (direct ``with A: ... with B:`` nesting plus one-call-deep
   interprocedural: holding A and calling a method that acquires B) becomes
   a directed edge ``A -> B``; a cycle in the graph is a potential deadlock
   and fails the audit. ``--graph`` prints the edges and their sites.

The runtime half lives in ``analysis/lock_tracer.py``: an opt-in sanitizer
(``BIGDL_LOCK_DEBUG=1`` + ``instrument_locks(obj)``) that wraps named locks,
records *actual* acquisition orders and hold times, and emits
``warn reason=lock_order_inversion`` / ``lock_hold_exceeded`` telemetry when
observed behavior contradicts this module's static graph.

Pure stdlib, importable by file path (no ``torch`` import). Suppressions use
the lint framework's syntax: ``# lint: disable=BDL017`` on the line, or
``# lint: disable-file=BDL017`` in the first 10 lines. Usage::

    python bigdl_tpu_torch/analysis/concurrency.py bigdl_tpu_torch   # audit
    python bigdl_tpu_torch/analysis/concurrency.py --entry-map ...    # pass 1
    python bigdl_tpu_torch/analysis/concurrency.py --graph ...        # pass 4
    python bigdl_tpu_torch/analysis/concurrency.py --selftest         # fixtures
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

# The threaded subsystem: the only files the repo audit looks at. Matched by
# path suffix so both `bigdl_tpu_torch/serving/queue.py` and a test fixture named
# `serving/queue.py` are in scope.
CONCURRENCY_SCOPE_FILES = (
    "serving/queue.py",
    "serving/batcher.py",
    "serving/server.py",
    "serving/resilience.py",
    "serving/artifacts.py",
    "dataset/pipeline.py",
    "dataset/files.py",
    "obs/watchdog.py",
    "obs/export.py",
    "obs/fleet.py",
    "obs/telemetry.py",
    "resilience/chaos.py",
    "resilience/policy.py",
    "resilience/preemption.py",
    "resilience/errors.py",
)

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

# Known-blocking callables banned under # hot-lock locks (BDL018). Each is a
# predicate domain handled in _record_call; this set is the doc of record.
_BLOCKING_SLEEP = {"sleep"}
_HTTP_ROOTS = {"socket", "urllib", "requests", "http"}
# argument-free methods that copy a (CUDA) tensor to the host
_DEVICE_TO_HOST = {"item", "tolist", "cpu", "numpy"}

# constructors whose instances we give a nominal type for call resolution
_MONITOR_BASES = {"MonitorBase"}
_HTTP_HANDLER_BASES = {"BaseHTTPRequestHandler", "SimpleHTTPRequestHandler"}


@dataclass
class Finding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _suppressed(src_lines: Sequence[str], lineno: int, code: str) -> bool:
    """Same suppression contract as tools/lint_framework.py."""
    if not 1 <= lineno <= len(src_lines):
        return False
    text = src_lines[lineno - 1]
    if "lint: disable=" in text and code in text.split("lint: disable=", 1)[1]:
        return True
    for head in src_lines[:10]:
        if "lint: disable-file=" in head and code in head.split(
            "lint: disable-file=", 1
        )[1]:
            return True
    return False


def _attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


# --------------------------------------------------------------------------
# program model
# --------------------------------------------------------------------------

# A lock node is ("ClassName", "_attr") or ("<module:path>", "_name").
LockNode = Tuple[str, str]


@dataclass
class LockDecl:
    node: LockNode
    kind: str                       # lock | rlock | condition
    path: str
    line: int
    hot: bool = False               # carries a "# hot-lock" annotation
    linked: Optional[str] = None    # Condition(self._x) -> "_x"


@dataclass
class Access:
    attr: str
    write: bool
    line: int
    held: Tuple[LockNode, ...]


@dataclass
class CallSite:
    targets: Tuple[str, ...]        # candidate callee qualnames
    line: int
    held: Tuple[LockNode, ...]


@dataclass
class Acquire:
    node: LockNode
    line: int
    held: Tuple[LockNode, ...]      # locks already held when acquiring


@dataclass
class CondOp:
    op: str                         # wait | notify | notify_all
    node: LockNode
    line: int
    held: Tuple[LockNode, ...]
    in_loop: bool


@dataclass
class BlockingCall:
    desc: str
    line: int
    held: Tuple[LockNode, ...]
    # a cond's own wait releases its lock; never "blocking under" itself
    releases: Tuple[LockNode, ...] = ()


@dataclass
class FuncInfo:
    qualname: str                   # "Class.method" | "func" | "Class.m.<worker>"
    cls: Optional[str]
    name: str
    path: str
    line: int
    accesses: List[Access] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    acquires: List[Acquire] = field(default_factory=list)
    cond_ops: List[CondOp] = field(default_factory=list)
    blocking: List[BlockingCall] = field(default_factory=list)
    spawns: List[Tuple[str, int]] = field(default_factory=list)  # (qualname, line)
    tags: Set[str] = field(default_factory=set)


@dataclass
class ClassDecl:
    name: str
    path: str
    line: int
    bases: Tuple[str, ...]
    locks: Dict[str, LockDecl] = field(default_factory=dict)
    guarded_by: Dict[str, str] = field(default_factory=dict)   # attr -> lock attr
    attr_types: Dict[str, str] = field(default_factory=dict)   # attr -> class name
    methods: Dict[str, FuncInfo] = field(default_factory=dict)


class Program:
    """The parsed whole-program model over the audited files."""

    def __init__(self) -> None:
        self.classes: Dict[str, ClassDecl] = {}
        self.funcs: Dict[str, FuncInfo] = {}       # every FuncInfo by qualname
        self.module_locks: Dict[str, Dict[str, LockDecl]] = {}  # path -> name -> decl
        self.src_lines: Dict[str, List[str]] = {}

    # -------------------------------------------------------------- resolve
    def class_mro(self, name: str, _seen: Optional[Set[str]] = None) -> List[str]:
        _seen = _seen or set()
        if name in _seen or name not in self.classes:
            return []
        _seen.add(name)
        out = [name]
        for b in self.classes[name].bases:
            out.extend(self.class_mro(b, _seen))
        return out

    def has_base(self, cls: str, bases: Set[str]) -> bool:
        return any(
            c in bases or any(b in bases for b in self.classes[c].bases)
            for c in self.class_mro(cls)
            if c in self.classes
        ) or any(b in bases for b in self.classes.get(cls, ClassDecl(cls, "", 0, ())).bases)

    def resolve_method(self, cls: str, meth: str) -> Optional[str]:
        for c in self.class_mro(cls):
            q = f"{c}.{meth}"
            if q in self.funcs:
                return q
        return None

    def find_lock(self, cls: Optional[str], attr: str) -> Optional[LockDecl]:
        if cls is None:
            return None
        for c in self.class_mro(cls):
            decl = self.classes[c].locks.get(attr)
            if decl is not None:
                return decl
        return None


# --------------------------------------------------------------------------
# per-file collection
# --------------------------------------------------------------------------


class _FuncWalker:
    """Walks one function body tracking the held-lock set statement by
    statement, recording attribute accesses, calls, acquisitions, condition
    ops, blocking calls, and spawn seams."""

    def __init__(self, prog: Program, cls: Optional[ClassDecl],
                 info: FuncInfo, src_lines: List[str]):
        self.prog = prog
        self.cls = cls
        self.info = info
        self.src_lines = src_lines
        self.local_types: Dict[str, str] = {}     # var -> class name
        self.nested: Dict[str, FuncInfo] = {}     # local def name -> info

    # ----------------------------------------------------------- lock nodes
    def _lock_of_expr(self, expr: ast.AST) -> Optional[LockDecl]:
        """Resolve `self._x` / module-level `_x` to a known lock decl."""
        chain = _attr_chain(expr)
        if chain is None:
            return None
        if len(chain) == 2 and chain[0] == "self" and self.cls is not None:
            return self.prog.find_lock(self.cls.name, chain[1])
        if len(chain) == 1:
            decls = self.prog.module_locks.get(self.info.path, {})
            return decls.get(chain[0])
        return None

    def _held_plus(self, held: Tuple[LockNode, ...],
                   decl: LockDecl) -> Tuple[LockNode, ...]:
        extra = [decl.node]
        if decl.linked and self.cls is not None:
            link = self.prog.find_lock(self.cls.name, decl.linked)
            if link is not None:
                extra.append(link.node)
        return held + tuple(n for n in extra if n not in held)

    # ------------------------------------------------------------ statements
    def walk(self, body: List[ast.stmt]) -> None:
        self._walk_body(body, held=(), loop_depth=0)

    def _walk_body(self, body: List[ast.stmt], held: Tuple[LockNode, ...],
                   loop_depth: int) -> None:
        for stmt in body:
            self._walk_stmt(stmt, held, loop_depth)

    def _walk_stmt(self, stmt: ast.stmt, held: Tuple[LockNode, ...],
                   loop_depth: int) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                decl = self._lock_of_expr(item.context_expr)
                self._walk_expr(item.context_expr, held, loop_depth)
                if decl is not None:
                    if decl.node not in new_held:
                        self.info.acquires.append(
                            Acquire(decl.node, stmt.lineno, new_held)
                        )
                    new_held = self._held_plus(new_held, decl)
            self._walk_body(stmt.body, new_held, loop_depth)
            return
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            for e in ast.iter_child_nodes(stmt):
                if isinstance(e, ast.expr):
                    self._walk_expr(e, held, loop_depth)
            self._walk_body(stmt.body, held, loop_depth + 1)
            self._walk_body(stmt.orelse, held, loop_depth)
            return
        if isinstance(stmt, ast.If):
            self._walk_expr(stmt.test, held, loop_depth)
            self._walk_body(stmt.body, held, loop_depth)
            self._walk_body(stmt.orelse, held, loop_depth)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, held, loop_depth)
            for h in stmt.handlers:
                self._walk_body(h.body, held, loop_depth)
            self._walk_body(stmt.orelse, held, loop_depth)
            self._walk_body(stmt.finalbody, held, loop_depth)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = FuncInfo(
                qualname=f"{self.info.qualname}.<{stmt.name}>",
                cls=self.cls.name if self.cls else None,
                name=stmt.name,
                path=self.info.path,
                line=stmt.lineno,
            )
            self.prog.funcs[sub.qualname] = sub
            self.nested[stmt.name] = sub
            w = _FuncWalker(self.prog, self.cls, sub, self.src_lines)
            w.local_types = dict(self.local_types)
            w.walk(stmt.body)
            return
        if isinstance(stmt, ast.ClassDef):
            return  # local classes: out of scope
        # leaf statements: record local types then walk expressions
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            ctor = stmt.value.func
            cname = ctor.id if isinstance(ctor, ast.Name) else (
                ctor.attr if isinstance(ctor, ast.Attribute) else None
            )
            if cname in self.prog.classes:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.local_types[t.id] = cname
        for e in ast.iter_child_nodes(stmt):
            if isinstance(e, ast.expr):
                self._walk_expr(e, held, loop_depth)

    # ----------------------------------------------------------- expressions
    def _walk_expr(self, expr: ast.expr, held: Tuple[LockNode, ...],
                   loop_depth: int) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                self._record_attr(node, held)
            elif isinstance(node, ast.Call):
                self._record_call(node, held, loop_depth)
            elif isinstance(node, (ast.Lambda,)):
                pass

    def _record_attr(self, node: ast.Attribute, held: Tuple[LockNode, ...]) -> None:
        chain = _attr_chain(node)
        if chain is None or len(chain) != 2 or chain[0] != "self":
            return
        if self.cls is not None and self.prog.find_lock(self.cls.name, chain[1]):
            return  # the lock objects themselves are not guarded state
        write = isinstance(node.ctx, (ast.Store, ast.AugStore)) if hasattr(
            ast, "AugStore"
        ) else isinstance(node.ctx, ast.Store)
        if isinstance(node.ctx, ast.Del):
            write = True
        self.info.accesses.append(Access(chain[1], write, node.lineno, held))

    def _resolve_call_targets(self, node: ast.Call) -> Tuple[str, ...]:
        """Candidate callee qualnames for tag/lock propagation."""
        func = node.func
        chain = _attr_chain(func)
        targets: List[str] = []
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.nested:
                targets.append(self.nested[name].qualname)
            elif name in self.prog.funcs:
                targets.append(name)
        elif chain is not None and len(chain) == 2 and chain[0] == "self":
            if self.cls is not None:
                q = self.prog.resolve_method(self.cls.name, chain[1])
                if q:
                    targets.append(q)
        elif chain is not None and len(chain) == 3 and chain[0] == "self":
            # self.<attr>.<meth>() through a typed attribute
            if self.cls is not None:
                for c in self.prog.class_mro(self.cls.name):
                    t = self.prog.classes[c].attr_types.get(chain[1])
                    if t:
                        q = self.prog.resolve_method(t, chain[2])
                        if q:
                            targets.append(q)
                        break
        elif chain is not None and len(chain) == 2 and chain[0] in self.local_types:
            q = self.prog.resolve_method(self.local_types[chain[0]], chain[1])
            if q:
                targets.append(q)
        return tuple(targets)

    def _spawn_target(self, node: ast.Call) -> Optional[str]:
        """Resolve the target of spawn_worker(...) / threading.Thread(target=)."""
        func = node.func
        chain = _attr_chain(func)
        name = func.id if isinstance(func, ast.Name) else (
            chain[-1] if chain else None
        )
        if name == "spawn_worker":
            tgt = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "target"), None
            )
        elif name == "Thread":
            tgt = next(
                (k.value for k in node.keywords if k.arg == "target"), None
            )
        else:
            return None
        if tgt is None:
            return None
        tchain = _attr_chain(tgt)
        if tchain and len(tchain) == 2 and tchain[0] == "self" and self.cls:
            return self.prog.resolve_method(self.cls.name, tchain[1])
        if isinstance(tgt, ast.Name):
            if tgt.id in self.nested:
                return self.nested[tgt.id].qualname
            if tgt.id in self.prog.funcs:
                return tgt.id
        return None

    def _record_call(self, node: ast.Call, held: Tuple[LockNode, ...],
                     loop_depth: int) -> None:
        targets = self._resolve_call_targets(node)
        if targets:
            self.info.calls.append(CallSite(targets, node.lineno, held))
        spawn = self._spawn_target(node)
        if spawn:
            self.info.spawns.append((spawn, node.lineno))
        chain = _attr_chain(node.func)
        # condition ops -------------------------------------------------
        if chain and chain[-1] in ("wait", "notify", "notify_all"):
            decl = self._lock_of_expr(
                node.func.value if isinstance(node.func, ast.Attribute) else node.func
            )
            if decl is not None and decl.kind == "condition":
                self.info.cond_ops.append(CondOp(
                    chain[-1], decl.node, node.lineno, held, loop_depth > 0
                ))
                if chain[-1] == "wait":
                    # wait() releases its own condition/lock while blocked
                    rel = [decl.node]
                    if decl.linked and self.cls is not None:
                        link = self.prog.find_lock(self.cls.name, decl.linked)
                        if link is not None:
                            rel.append(link.node)
                    self.info.blocking.append(BlockingCall(
                        f"{'.'.join(chain)}()", node.lineno, held, tuple(rel)
                    ))
                return
        # blocking calls ------------------------------------------------
        desc = self._blocking_desc(node, chain)
        if desc is not None:
            self.info.blocking.append(BlockingCall(desc, node.lineno, held))

    def _blocking_desc(self, node: ast.Call,
                       chain: Optional[Tuple[str, ...]]) -> Optional[str]:
        func = node.func
        has_timeout = any(
            k.arg == "timeout" and not (
                isinstance(k.value, ast.Constant) and k.value.value is None
            )
            for k in node.keywords
        )
        if chain is not None:
            # time.sleep(...) and bare sleep(...) from `from time import sleep`
            if chain[-1] in _BLOCKING_SLEEP and (
                len(chain) == 1 or chain[0] == "time"
            ):
                return f"{'.'.join(chain)}()"
            if chain[0] in _HTTP_ROOTS and len(chain) >= 2:
                return f"{'.'.join(chain)}()"
            if chain[-1] == "urlopen":
                return f"{'.'.join(chain)}()"
            if (
                len(chain) >= 2
                and chain[0] in ("np", "numpy")
                and chain[-1] in ("asarray", "array")
            ):
                return f"{'.'.join(chain)}()"
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = func.value
            # device materialization on any receiver (``y[i].item()`` too):
            # a host copy of a CUDA tensor, or a wait on the card
            if attr == "synchronize":
                return f"{'.'.join(chain)}()" if chain else ".synchronize()"
            if attr in _DEVICE_TO_HOST and not node.args and not node.keywords:
                return f".{attr}()"
            if attr == "join":
                # skip str.join ("...".join(parts)) and os.path.join
                if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
                    return None
                rchain = _attr_chain(recv)
                if rchain and rchain[0] in ("os", "posixpath", "ntpath"):
                    return None
                return ".join()"
            if attr == "result" and not has_timeout:
                # Future.result() with no timeout can block forever
                return ".result() (no timeout)"
            if attr in ("get", "put") and not has_timeout:
                # only queue-typed receivers: dict.get etc. stay free
                if self._is_queue_expr(recv) and not any(
                    isinstance(a, ast.Constant) and a.value is False
                    for a in node.args[:1]
                ):
                    return f".{attr}() (no timeout)"
        return None

    def _is_queue_expr(self, recv: ast.AST) -> bool:
        chain = _attr_chain(recv)
        if chain is None:
            return False
        if len(chain) == 2 and chain[0] == "self" and self.cls is not None:
            for c in self.prog.class_mro(self.cls.name):
                if self.prog.classes[c].attr_types.get(chain[1]) == "Queue":
                    return True
        if len(chain) == 1:
            return self.local_types.get(chain[0]) == "Queue"
        return False


def _line_annotation(src_lines: List[str], lineno: int, marker: str) -> Optional[str]:
    """Return the value after `marker:` in the line's comment, if present."""
    if not 1 <= lineno <= len(src_lines):
        return None
    text = src_lines[lineno - 1]
    if "#" not in text:
        return None
    comment = text.split("#", 1)[1]
    if marker not in comment:
        return None
    tail = comment.split(marker, 1)[1].lstrip(" :")
    token = tail.split()[0].rstrip(",;)") if tail.split() else ""
    return token or ""


def _collect_file(prog: Program, path: str, src: str, tree: ast.AST) -> None:
    src_lines = src.split("\n")
    prog.src_lines[path] = src_lines
    mod_key = f"<module:{os.path.basename(path)}>"
    prog.module_locks.setdefault(path, {})

    def lock_kind(call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
        chain = _attr_chain(call.func)
        name = None
        if isinstance(call.func, ast.Name):
            name = call.func.id
        elif chain and len(chain) == 2 and chain[0] == "threading":
            name = chain[1]
        if name not in _LOCK_CTORS:
            return None
        linked = None
        if name == "Condition" and call.args:
            achain = _attr_chain(call.args[0])
            if achain and len(achain) == 2 and achain[0] == "self":
                linked = achain[1]
        return _LOCK_CTORS[name], linked

    # module-level locks + functions + classes
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            lk = lock_kind(node.value)
            if lk is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        hot = _line_annotation(
                            src_lines, node.lineno, "hot-lock"
                        ) is not None
                        prog.module_locks[path][t.id] = LockDecl(
                            (mod_key, t.id), lk[0], path, node.lineno, hot, lk[1]
                        )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = FuncInfo(node.name, None, node.name, path, node.lineno)
            prog.funcs[info.qualname] = info
        elif isinstance(node, ast.ClassDef):
            bases = tuple(
                b.id if isinstance(b, ast.Name) else b.attr
                for b in node.bases
                if isinstance(b, (ast.Name, ast.Attribute))
            )
            cls = ClassDecl(node.name, path, node.lineno, bases)
            prog.classes[node.name] = cls
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{node.name}.{item.name}"
                    info = FuncInfo(q, node.name, item.name, path, item.lineno)
                    prog.funcs[q] = info
                    cls.methods[item.name] = info

    # second sweep inside class bodies: lock decls, guarded-by annotations,
    # attribute types (self.x = ClassName(...))
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        cls = prog.classes[node.name]
        for item in ast.walk(node):
            # an annotated assignment (``self._x: List[T] = []``) declares
            # too: the JAX auditor reads only plain ones
            if isinstance(item, ast.AnnAssign) and item.value is not None:
                targets = [item.target]
            elif isinstance(item, ast.Assign):
                targets = item.targets
            else:
                continue
            for t in targets:
                chain = _attr_chain(t)
                if not (chain and len(chain) == 2 and chain[0] == "self"):
                    continue
                attr = chain[1]
                if isinstance(item.value, ast.Call):
                    lk = lock_kind(item.value)
                    if lk is not None:
                        hot = _line_annotation(
                            src_lines, item.lineno, "hot-lock"
                        ) is not None
                        cls.locks[attr] = LockDecl(
                            (cls.name, attr), lk[0], path, item.lineno,
                            hot, lk[1],
                        )
                        continue
                    ctor = item.value.func
                    cname = ctor.id if isinstance(ctor, ast.Name) else (
                        ctor.attr if isinstance(ctor, ast.Attribute) else None
                    )
                    if cname is not None:
                        cls.attr_types.setdefault(attr, cname)
                g = _line_annotation(src_lines, item.lineno, "guarded-by")
                if g:
                    cls.guarded_by[attr] = g


def build_program(paths: Sequence[str]) -> Tuple[Program, List[Finding]]:
    prog = Program()
    findings: List[Finding] = []
    parsed: List[Tuple[str, str, ast.AST]] = []
    for f in paths:
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=f)
        except SyntaxError as e:
            findings.append(
                Finding(f, e.lineno or 1, "BDL000", f"syntax error: {e.msg}")
            )
            continue
        parsed.append((f, src, tree))
    for f, src, tree in parsed:
        _collect_file(prog, f, src, tree)
    # walk every function body now that classes/locks are all known
    for f, src, tree in parsed:
        src_lines = prog.src_lines[f]
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = prog.funcs[node.name]
                _FuncWalker(prog, None, info, src_lines).walk(node.body)
            elif isinstance(node, ast.ClassDef):
                cls = prog.classes[node.name]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info = cls.methods[item.name]
                        _FuncWalker(prog, cls, info, src_lines).walk(item.body)
    _seed_and_propagate_tags(prog)
    return prog, findings


# --------------------------------------------------------------------------
# pass 1: thread-entry mapping
# --------------------------------------------------------------------------


def _seed_and_propagate_tags(prog: Program) -> None:
    # main-thread seeds: public module functions + public methods
    for q, info in prog.funcs.items():
        if "<" in q:
            continue  # nested defs only run where their spawner puts them
        if not info.name.startswith("_") or info.name in (
            "__call__", "__iter__", "__next__", "__enter__", "__exit__",
        ):
            info.tags.add("main")
    # spawn seams -> worker tags
    for info in list(prog.funcs.values()):
        for target, _line in info.spawns:
            t = prog.funcs.get(target)
            if t is not None:
                t.tags.add(f"worker:{t.qualname}")
    # monitor poll entries: subclasses of MonitorBase run check() on the
    # monitor thread (MonitorBase._poll -> self.check fixpoint covers the
    # base, but subclasses override check in their own class)
    for cls in prog.classes.values():
        mro = prog.class_mro(cls.name)
        if any(c in _MONITOR_BASES for c in mro) or any(
            b in _MONITOR_BASES for c in mro for b in prog.classes[c].bases
        ):
            q = prog.resolve_method(cls.name, "check")
            if q:
                prog.funcs[q].tags.add(f"monitor:{cls.name}")
            q = prog.resolve_method(cls.name, "_poll")
            if q:
                prog.funcs[q].tags.add(f"monitor:{cls.name}")
        if any(
            b in _HTTP_HANDLER_BASES
            for c in mro
            for b in prog.classes.get(c, ClassDecl(c, "", 0, ())).bases
        ) or any(b in _HTTP_HANDLER_BASES for b in cls.bases):
            for m, info in cls.methods.items():
                if m.startswith("do_"):
                    info.tags.add(f"http:{cls.name}")
    # propagate over the call graph to a fixpoint
    changed = True
    while changed:
        changed = False
        for info in prog.funcs.values():
            if not info.tags:
                continue
            for call in info.calls:
                for tq in call.targets:
                    t = prog.funcs.get(tq)
                    if t is not None and not info.tags <= t.tags:
                        t.tags |= info.tags
                        changed = True


def entry_map(prog: Program) -> Dict[str, List[str]]:
    return {
        q: sorted(info.tags)
        for q, info in sorted(prog.funcs.items())
        if info.tags
    }


# --------------------------------------------------------------------------
# pass 2: lock-discipline inference (BDL017)
# --------------------------------------------------------------------------


def _guard_map(prog: Program, cls: ClassDecl) -> Dict[str, LockDecl]:
    """attr -> guarding LockDecl, from annotations + write inference."""
    out: Dict[str, LockDecl] = {}
    for attr, lock_attr in cls.guarded_by.items():
        decl = prog.find_lock(cls.name, lock_attr)
        if decl is not None:
            out[attr] = decl
    # inference: every non-__init__ write under one common lock
    writes: Dict[str, List[Access]] = {}
    for m, info in cls.methods.items():
        if m == "__init__":
            continue
        for a in info.accesses:
            if a.write:
                writes.setdefault(a.attr, []).append(a)
    for attr, accs in writes.items():
        if attr in out or attr in cls.attr_types:
            continue
        common: Optional[Set[LockNode]] = None
        for a in accs:
            s = set(a.held)
            common = s if common is None else (common & s)
        if not common:
            continue
        # prefer this class's own locks, deterministic order
        own = sorted(
            n for n in common if prog.find_lock(cls.name, n[1]) is not None
        )
        if own:
            decl = prog.find_lock(cls.name, own[0][1])
            if decl is not None:
                out.setdefault(attr, decl)
    return out


def _held_satisfies(held: Tuple[LockNode, ...], decl: LockDecl,
                    prog: Program, cls: ClassDecl) -> bool:
    if decl.node in held:
        return True
    # holding a Condition linked to the guard lock counts, and vice versa
    for n in held:
        d = prog.find_lock(cls.name, n[1])
        if d is not None and d.linked == decl.node[1]:
            return True
    if decl.kind == "condition" and decl.linked:
        link = prog.find_lock(cls.name, decl.linked)
        if link is not None and link.node in held:
            return True
    return False


def check_lock_discipline(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    for cls in prog.classes.values():
        guards = _guard_map(prog, cls)
        if not guards:
            continue
        # which threads touch each guarded attr?
        touch_tags: Dict[str, Set[str]] = {a: set() for a in guards}
        for m, info in cls.methods.items():
            if m == "__init__":
                continue
            for a in info.accesses:
                if a.attr in guards:
                    touch_tags[a.attr] |= info.tags
        for m, info in cls.methods.items():
            if m == "__init__":
                continue
            for a in info.accesses:
                decl = guards.get(a.attr)
                if decl is None:
                    continue
                if len(touch_tags[a.attr]) < 2:
                    continue  # single-thread attribute: no race to have
                if _held_satisfies(a.held, decl, prog, cls):
                    continue
                kind = "written" if a.write else "read"
                src = "annotated" if a.attr in cls.guarded_by else "inferred"
                findings.append(Finding(
                    cls.path, a.line, "BDL017",
                    f"{cls.name}.{a.attr} ({src} guarded-by "
                    f"{decl.node[1]}) {kind} without the lock held in "
                    f"{info.qualname}(), which is reachable from threads "
                    f"{{{', '.join(sorted(touch_tags[a.attr]))}}}; take the "
                    "lock, or suppress with the invariant that makes the "
                    "unlocked access safe",
                ))
    return findings


# --------------------------------------------------------------------------
# pass 3: wait/notify + blocking-under-hot-lock (BDL018)
# --------------------------------------------------------------------------


def check_wait_notify(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    for info in prog.funcs.values():
        for op in info.cond_ops:
            lockname = op.node[1]
            if op.node not in op.held:
                findings.append(Finding(
                    info.path, op.line, "BDL018",
                    f"{lockname}.{op.op}() called without holding the "
                    "condition: wait/notify outside the lock races the "
                    "predicate it synchronizes (RuntimeError at best, lost "
                    "wakeup at worst)",
                ))
                continue
            if op.op == "wait" and not op.in_loop:
                findings.append(Finding(
                    info.path, op.line, "BDL018",
                    f"{lockname}.wait() outside a while-predicate loop: "
                    "condition wakeups are advisory (spurious wakeups, "
                    "stolen predicates) — re-check the predicate in a "
                    "`while` around the wait, or suppress with the "
                    "invariant that bounds the sleep",
                ))
    return findings


def _hot_locks(prog: Program) -> Set[LockNode]:
    out: Set[LockNode] = set()
    for cls in prog.classes.values():
        for decl in cls.locks.values():
            if decl.hot:
                out.add(decl.node)
    for decls in prog.module_locks.values():
        for decl in decls.values():
            if decl.hot:
                out.add(decl.node)
    return out


def check_blocking_under_hot_locks(prog: Program) -> List[Finding]:
    hot = _hot_locks(prog)
    if not hot:
        return []
    findings: List[Finding] = []
    for info in prog.funcs.values():
        for b in info.blocking:
            held_hot = [
                n for n in b.held if n in hot and n not in b.releases
            ]
            if not held_hot:
                continue
            names = ", ".join(f"{c}.{a}" for c, a in held_hot)
            findings.append(Finding(
                info.path, b.line, "BDL018",
                f"blocking call {b.desc} while holding hot lock(s) "
                f"{names} in {info.qualname}(): one blocked holder stalls "
                "every thread contending for the lock — move the blocking "
                "work outside the critical section, or suppress with the "
                "bound that keeps the hold short",
            ))
    return findings


# --------------------------------------------------------------------------
# pass 4: lock-order graph (BDL019)
# --------------------------------------------------------------------------


def _locks_acquired(prog: Program, qualname: str,
                    _seen: Optional[Set[str]] = None) -> Set[LockNode]:
    """All locks a function may acquire, one-call-deep transitively."""
    _seen = _seen or set()
    if qualname in _seen:
        return set()
    _seen.add(qualname)
    info = prog.funcs.get(qualname)
    if info is None:
        return set()
    out = {a.node for a in info.acquires}
    for call in info.calls:
        for t in call.targets:
            out |= _locks_acquired(prog, t, _seen)
    return out


def lock_order_graph(prog: Program) -> Dict[Tuple[LockNode, LockNode],
                                            List[Tuple[str, int]]]:
    """Directed edges ``held -> acquired`` with their source sites."""
    edges: Dict[Tuple[LockNode, LockNode], List[Tuple[str, int]]] = {}
    for info in prog.funcs.values():
        for acq in info.acquires:
            for h in acq.held:
                if h == acq.node:
                    continue
                edges.setdefault((h, acq.node), []).append(
                    (info.path, acq.line)
                )
        for call in info.calls:
            if not call.held:
                continue
            for t in call.targets:
                for m in _locks_acquired(prog, t):
                    for h in call.held:
                        if h == m:
                            continue
                        edges.setdefault((h, m), []).append(
                            (info.path, call.line)
                        )
    return edges


def find_cycles(edges: Dict[Tuple[LockNode, LockNode], List[Tuple[str, int]]]
                ) -> List[List[LockNode]]:
    adj: Dict[LockNode, List[LockNode]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    cycles: List[List[LockNode]] = []
    seen_cycles: Set[Tuple[LockNode, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: List[LockNode] = []

    def dfs(n: LockNode) -> None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(adj[n]):
            if color[m] == GRAY:
                i = stack.index(m)
                cyc = stack[i:] + [m]
                key = tuple(sorted(set(cyc)))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif color[m] == WHITE:
                dfs(m)
        stack.pop()
        color[n] = BLACK

    for n in sorted(adj):
        if color[n] == WHITE:
            dfs(n)
    return cycles


def check_lock_order(prog: Program) -> List[Finding]:
    edges = lock_order_graph(prog)
    findings: List[Finding] = []
    for cyc in find_cycles(edges):
        path_str = " -> ".join(f"{c}.{a}" for c, a in cyc)
        # anchor the finding at the first edge site of the cycle
        first_edge = (cyc[0], cyc[1])
        sites = edges.get(first_edge, [("<unknown>", 1)])
        f, line = sites[0]
        findings.append(Finding(
            f, line, "BDL019",
            f"lock-order cycle: {path_str} — two threads taking these "
            "locks in opposite orders deadlock; pick one global order "
            "(document it on the lock decls) and release before "
            "re-acquiring against it",
        ))
    return findings


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d not in ("__pycache__", ".git")
                )
                out.extend(
                    os.path.join(root, f)
                    for f in sorted(files)
                    if f.endswith(".py")
                )
    return out


def scope_filter(files: Sequence[str]) -> List[str]:
    out = []
    for f in files:
        norm = f.replace(os.sep, "/")
        if norm.endswith(CONCURRENCY_SCOPE_FILES):
            out.append(f)
    return out


def audit_paths(paths: Sequence[str], in_scope_only: bool = True
                ) -> List[Finding]:
    """Run all four passes; returns unsuppressed findings."""
    files = iter_py_files(paths)
    if in_scope_only:
        files = scope_filter(files)
    if not files:
        return []
    prog, findings = build_program(files)
    findings.extend(check_lock_discipline(prog))
    findings.extend(check_wait_notify(prog))
    findings.extend(check_blocking_under_hot_locks(prog))
    findings.extend(check_lock_order(prog))
    out = []
    for f in findings:
        lines = prog.src_lines.get(f.path, [])
        if not _suppressed(lines, f.line, f.code):
            out.append(f)
    out.sort(key=lambda x: (x.path, x.line, x.code))
    return out


def static_order_edges(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """The static lock-order relation as ``"Owner.attr" -> "Owner.attr"``
    name pairs — what the runtime sanitizer asserts observed orders
    against (``analysis.lock_tracer.LockTracer(static_edges=...)``)."""
    files = scope_filter(iter_py_files(paths))
    prog, _ = build_program(files)
    return {
        (f"{a[0]}.{a[1]}", f"{b[0]}.{b[1]}")
        for (a, b) in lock_order_graph(prog)
    }


# --------------------------------------------------------------------------
# selftest fixtures: each rule must fire on its positive fixture and stay
# quiet on the clean one, so a broken pass can never silently let the
# package through.
# --------------------------------------------------------------------------

_FIXTURE_BDL017 = '''
import threading

def spawn_worker(target, name=None):
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: _lock
        spawn_worker(self._loop)

    def _loop(self):
        with self._lock:
            self._count += 1

    def read(self):
        return self._count
'''

_FIXTURE_BDL017_CLEAN = '''
import threading

def spawn_worker(target, name=None):
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: _lock
        spawn_worker(self._loop)

    def _loop(self):
        with self._lock:
            self._count += 1

    def read(self):
        with self._lock:
            return self._count
'''

_FIXTURE_BDL018_WAIT = '''
import threading

class Ring:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items = []

    def get(self):
        with self._cond:
            if not self._items:
                self._cond.wait()
            return self._items.pop()
'''

_FIXTURE_BDL018_HOT = '''
import threading
import time

class Batcher:
    def __init__(self):
        self._swap_lock = threading.Lock()  # hot-lock: dispatch exclusion

    def flush(self):
        with self._swap_lock:
            time.sleep(0.5)
'''

_FIXTURE_BDL019 = '''
import threading

class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                pass

    def ba(self):
        with self._b:
            with self._a:
                pass
'''

_FIXTURE_CLEAN_ORDER = '''
import threading

class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                pass

    def also_ab(self):
        with self._a:
            with self._b:
                pass
'''


def _selftest() -> int:
    import tempfile

    failures: List[str] = []

    def audit_fixture(src: str, name: str = "serving/queue.py") -> List[Finding]:
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, name)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w", encoding="utf-8") as fh:
                fh.write(src)
            return audit_paths([p])

    def expect(desc: str, found: List[Finding], codes: List[str]) -> None:
        got = [f.code for f in found]
        if got != codes:
            failures.append(f"{desc}: expected {codes}, got "
                            f"{[str(f) for f in found]}")

    expect("BDL017 unlocked cross-thread read",
           audit_fixture(_FIXTURE_BDL017), ["BDL017"])
    expect("BDL017 clean (locked read)",
           audit_fixture(_FIXTURE_BDL017_CLEAN), [])
    expect("BDL018 wait outside while-loop",
           audit_fixture(_FIXTURE_BDL018_WAIT), ["BDL018"])
    expect("BDL018 sleep under hot lock",
           audit_fixture(_FIXTURE_BDL018_HOT), ["BDL018"])
    expect("BDL019 lock-order cycle",
           audit_fixture(_FIXTURE_BDL019), ["BDL019"])
    expect("BDL019 clean (consistent order)",
           audit_fixture(_FIXTURE_CLEAN_ORDER), [])

    # the repo itself: audit-clean, and the committed lock-order fixture —
    # the serving tier's two sanctioned nestings are present and the whole
    # graph over serving/+dataset/+obs/+resilience/ stays acyclic
    repo = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    lib = os.path.join(repo, "bigdl_tpu_torch")
    if os.path.isdir(lib):
        repo_findings = audit_paths([lib])
        if repo_findings:
            failures.append(
                "repo not audit-clean:\n  " + "\n  ".join(str(f) for f in repo_findings)
            )
        edges = static_order_edges([lib])
        expected_edges = {
            ("ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock"),
            ("ModelServer._mgmt_lock", "ModelServer._lock"),
        }
        missing = expected_edges - edges
        if missing:
            failures.append(f"expected lock-order edges missing: {missing}")
        files = scope_filter(iter_py_files([lib]))
        prog, _ = build_program(files)
        cycles = find_cycles(lock_order_graph(prog))
        if cycles:
            failures.append(f"repo lock-order graph has cycles: {cycles}")

    if failures:
        for f in failures:
            print(f"SELFTEST FAIL: {f}", file=sys.stderr)
        return 1
    print("concurrency audit selftest: all fixtures behaved")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", default=["bigdl_tpu_torch"])
    ap.add_argument("--entry-map", action="store_true",
                    help="print the thread-entry map (pass 1)")
    ap.add_argument("--graph", action="store_true",
                    help="print the lock-order graph (pass 4)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the fixture-driven selftest + repo-clean gate")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    files = scope_filter(iter_py_files(args.paths or ["bigdl_tpu_torch"]))
    if args.entry_map or args.graph:
        prog, errs = build_program(files)
        for e in errs:
            print(e)
        if args.entry_map:
            for q, tags in entry_map(prog).items():
                print(f"{q}: {', '.join(tags)}")
        if args.graph:
            edges = lock_order_graph(prog)
            for (a, b), sites in sorted(edges.items()):
                where = ", ".join(f"{os.path.basename(p)}:{l}" for p, l in sites[:3])
                print(f"{a[0]}.{a[1]} -> {b[0]}.{b[1]}  [{where}]")
            cycles = find_cycles(edges)
            for c in cycles:
                print("CYCLE: " + " -> ".join(f"{x[0]}.{x[1]}" for x in c))
        return 0
    findings = audit_paths(args.paths or ["bigdl_tpu_torch"])
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
