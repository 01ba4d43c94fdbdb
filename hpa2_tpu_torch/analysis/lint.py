"""AST lint for the port's engine code: the port of
``hpa2_tpu/analysis/lint.py``.

Eight rules, all tuned to be zero-finding on clean engine code
(``hpa2_tpu_torch/{models,ops,interconnect}``).  Six carry over from
the JAX package as they are; the two JAX-only rules have PyTorch
counterparts:

* **host-sync** (JAX: traced-branch) -- a Python ``if``/``while``/
  ternary/``assert`` test, ``bool()``, ``int()``, ``float()``,
  ``.item()`` or ``.tolist()`` on a device tensor, outside
  ``kernels.HOST_SYNCS.read``, in the code that runs between a run's
  launch and its status read (:data:`HOST_SYNC_SCOPE`: the fast path's
  run paths in ``ops/cuda_engine.py``, ``ops/call_run.py:run_windows``
  and ``run_windows_multi``,
  the general engine's ``Run``/``ChunkRun``/``BoundChunk`` card paths in
  ``ops/step.py``, and ``ops/session.py``).  On the card each such read
  waits for the device, so a read that does not go through
  ``HOST_SYNCS.read`` makes the sync counts lie.  Reads after a run
  (stats, dumps) and the CPU's host loops (``Run._run_host``,
  ``ChunkRun.run_host``/``host_step``, ``BoundChunk._status_host``) are
  outside the scope.  A
  value is a device tensor when it derives from a tensor parameter
  (``st``, ``state``, ``tr``, ...), a tensor attribute of ``self``, a
  ``torch.*`` call, or a call or method given one; static facts
  (``.shape``, ``.dtype``, ``.device``, ``.is_cuda``, ``is None``) are
  exempt.
* **nondeterminism** -- wall-clock or unseeded randomness in an engine
  path (``models/``, ``ops/``): ``time.*``, module-level ``random.*``,
  ``np.random.*``, ``datetime.now``.  Seeded ``random.Random(seed)``
  instances and keyed generators are allowed.
* **dtype-drift** (JAX: 64-bit jnp dtypes and platform widths) -- a
  platform-width ``dtype=int``/``dtype=float`` or ``astype(int)`` in an
  op module: the state planes are int32 (or u8/u16 packed), and a
  platform-width type computes them in another width than they carry.
* **dtype-widening** -- arithmetic (or an ``astype``) on a packed
  uint8/uint16 state plane (``cvalw``/``cmetaw``/``dmemw``/``dmetaw``
  and their ``snap_`` twins) outside the sanctioned ``_widen*`` /
  ``_narrow*`` helpers: PyTorch promotes the narrow operand silently.
* **dead-handler** -- ``spec_engine.py``'s ``_on_*`` methods must all be
  registered in ``_DISPATCH``, every registration must resolve, and
  every ``MsgType`` must be dispatched.
* **interconnect-purity** -- ``hpa2_tpu_torch/interconnect/`` may not
  even *import* ``random``/``time``/``datetime``/``uuid``/``secrets``.
* **hand-written-state** -- the general engine's step and the fast
  path's cycle (``ops/step.py``, ``ops/cycle.py``) may not import or
  spell ``CacheState``/``DirState`` enum constants; every protocol
  state resolves through the compiled ``ProtocolPlanes`` or the
  layout's constants.
* **counter-backfill** -- every only-when-nonzero stats counter read
  from a ``SimState`` field in ``ops/engine.py::engine_stats`` must be
  zero-backfilled by ``utils/checkpoint.py``'s ``_ZERO_BACKFILL``.

CLI: ``python -m hpa2_tpu_torch.analysis lint`` (a tier-1 test runs
it).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, List, Optional, Set

#: directories (repo-relative) whose files are engine paths
ENGINE_DIRS = (
    os.path.join("hpa2_tpu_torch", "models"),
    os.path.join("hpa2_tpu_torch", "ops"),
    os.path.join("hpa2_tpu_torch", "interconnect"),
)
#: op modules additionally subject to dtype-drift and dtype-widening
OPS_DIR = os.path.join("hpa2_tpu_torch", "ops")
#: the interconnect package: subject to the strict purity rule
INTERCONNECT_DIR = os.path.join("hpa2_tpu_torch", "interconnect")

#: the host-sync rule's scope: per op module, the functions (by
#: qualified name; a class name covers its methods) that run between a
#: run's launch and its status read on the card
HOST_SYNC_SCOPE = {
    os.path.join(OPS_DIR, "cuda_engine.py"): (
        "run_program", "run_programs", "read_status", "barrier_",
        "CudaEngine.run", "CudaEngine._programs",
        "CudaEngine._run_scheduled_fused", "CudaEngine._run_scheduled"),
    os.path.join(OPS_DIR, "call_run.py"): ("run_windows",
                                           "run_windows_multi"),
    os.path.join(OPS_DIR, "step.py"): (
        "Run.__call__", "Run.gated", "Run.advance_chunk", "Run._capture",
        "Run._run_graphed", "ChunkRun.gated", "ChunkRun.advance_chunk",
        "ChunkRun.__call__", "BoundChunk._capture", "BoundChunk._round",
        "BoundChunk._rounds", "BoundChunk.advance", "BoundChunk.status"),
    os.path.join(OPS_DIR, "session.py"): ("CudaLaneSession",),
}
#: parameter names treated as device tensors (or containers of them)
TENSOR_PARAMS = {"st", "state", "static", "tr", "tr_len", "tl", "x",
                 "status", "flag", "perm", "reset", "init", "c", "new"}
#: attribute leaves that are static facts of a tensor (no device read)
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}
#: tensor methods that return host facts
STATIC_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                  "is_contiguous", "stride"}
#: calls whose result is a host value whatever their arguments
HOST_CALLS = {"len", "isinstance", "range", "zip", "enumerate", "id",
              "tuple", "type", "hasattr", "getattr"}
#: the reads the rule looks for
READ_CASTS = {"bool", "int", "float"}
READ_METHODS = {"item", "tolist"}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_root(node: ast.AST) -> Optional[str]:
    """Root Name id of an attribute/subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


def _is_host_syncs_read(node: ast.AST) -> bool:
    """``HOST_SYNCS.read(...)`` / ``kernels.HOST_SYNCS.read(...)``."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "read"
            and (_attr_root(node.func.value) == "HOST_SYNCS"
                 or (isinstance(node.func.value, ast.Attribute)
                     and node.func.value.attr == "HOST_SYNCS")))


class _Taint:
    """Which expressions of one function are device tensors."""

    def __init__(self, names: Set[str], self_attrs: Set[str]):
        self.names = set(names)
        self.self_attrs = self_attrs

    def of(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                return expr.attr in self.self_attrs
            if isinstance(expr.value, ast.Name) and expr.value.id == "torch":
                return False  # a dtype or module attribute
            return self.of(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.of(expr.value)
        if isinstance(expr, ast.Call):
            if _is_host_syncs_read(expr):
                return False
            f = expr.func
            if isinstance(f, ast.Name) and (f.id in HOST_CALLS
                                            or f.id in READ_CASTS):
                return False
            if isinstance(f, ast.Attribute):
                if f.attr in STATIC_METHODS or f.attr in READ_METHODS:
                    return False
                if _attr_root(f) == "torch":
                    return True
                if self.of(f.value):
                    return True
            return any(self.of(a) for a in expr.args) or any(
                self.of(k.value) for k in expr.keywords)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            return self.of(expr.left) or any(
                self.of(c) for c in expr.comparators)
        if isinstance(expr, (ast.BinOp,)):
            return self.of(expr.left) or self.of(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.of(expr.operand)
        if isinstance(expr, ast.BoolOp):
            return any(self.of(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return self.of(expr.body) or self.of(expr.orelse)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.of(e) for e in expr.elts)
        return False

    def bind(self, target: ast.AST, device: bool = True) -> None:
        """Mark the names ``target`` binds as device tensors (or, with
        ``device=False``, as host values)."""
        for name in ast.walk(target):
            if isinstance(name, ast.Name):
                if device:
                    self.names.add(name.id)
                else:
                    self.names.discard(name.id)


def _tensor_self_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes a class assigns from tensor expressions (``self.X =``
    a ``torch.*`` call, a tensor parameter, ...), to a fixed point."""
    attrs: Set[str] = set()
    while True:
        found = set(attrs)
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = _Taint(_tensor_params(fn), found)
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) and taint.of(stmt.value):
                    for tgt in stmt.targets:
                        for t in ast.walk(tgt):
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                found.add(t.attr)
                            elif isinstance(t, ast.Name):
                                taint.names.add(t.id)
        if found == attrs:
            return attrs
        attrs = found


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """Parameters that hold device tensors: annotated as tensors or
    states, or named in :data:`TENSOR_PARAMS` and not annotated as
    host values."""
    out: Set[str] = set()
    for arg in fn.args.args + fn.args.kwonlyargs:
        ann = ast.unparse(arg.annotation) if arg.annotation else ""
        if "Tensor" in ann or "SimState" in ann or (
                arg.arg in TENSOR_PARAMS and not ann):
            out.add(arg.arg)
    return out


class _HostSyncVisitor:
    """Flags unaccounted device reads in the scoped functions."""

    def __init__(self, path: str, scope):
        self.path = path
        self.scope = scope
        self.findings: List[LintFinding] = []

    def _in_scope(self, qual: str) -> bool:
        return any(qual == s or qual.startswith(s + ".")
                   for s in self.scope)

    def visit_module(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                attrs = _tensor_self_attrs(node)
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        qual = f"{node.name}.{fn.name}"
                        if self._in_scope(qual):
                            self._scan(fn, attrs, qual)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._in_scope(node.name):
                    self._scan(node, set(), node.name)

    def _flag(self, node: ast.AST, qual: str, what: str) -> None:
        self.findings.append(LintFinding(
            "host-sync", self.path, node.lineno,
            f"{what} on a device tensor in {qual} -- on the card it "
            f"waits for the device; read it through "
            f"kernels.HOST_SYNCS.read so the sync counts hold"))

    def _scan(self, fn: ast.FunctionDef, attrs: Set[str],
              qual: str) -> None:
        self._block(fn.body, _Taint(_tensor_params(fn), attrs), qual)

    def _block(self, stmts, taint: _Taint, qual: str) -> None:
        """One pass over ``stmts`` in source order: an assignment binds
        its targets to its value's taint (a name re-bound to a host
        value is a host value from there on); nested bodies and nested
        functions (their reads run in the scoped function's time) are
        walked with the taint as it stands."""
        for stmt in stmts:
            for expr in _own_exprs(stmt):
                self._check(expr, taint, qual)
            if isinstance(stmt, (ast.If, ast.While)) \
                    and taint.of(stmt.test):
                self._flag(stmt, qual,
                           f"Python {type(stmt).__name__.lower()}")
            elif isinstance(stmt, ast.Assert) and taint.of(stmt.test):
                self._flag(stmt, qual, "assert")
            if isinstance(stmt, ast.Assign):
                dev = taint.of(stmt.value)
                for tgt in stmt.targets:
                    taint.bind(tgt, dev)
            elif isinstance(stmt, ast.AugAssign) and taint.of(stmt.value):
                taint.bind(stmt.target)
            elif isinstance(stmt, ast.For):
                taint.bind(stmt.target, taint.of(stmt.iter))
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = _Taint(taint.names | _tensor_params(stmt),
                               taint.self_attrs)
                self._block(stmt.body, inner, qual)
                continue
            for body in _own_blocks(stmt):
                self._block(body, taint, qual)

    def _check(self, expr: ast.AST, taint: _Taint, qual: str) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp) and taint.of(node.test):
                self._flag(node, qual, "ternary")
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in READ_CASTS \
                    and node.args and taint.of(node.args[0]):
                self._flag(node, qual, f"{f.id}()")
            elif isinstance(f, ast.Attribute) and f.attr in READ_METHODS \
                    and taint.of(f.value):
                self._flag(node, qual, f".{f.attr}()")


def _own_exprs(stmt: ast.stmt):
    """The expressions of ``stmt`` itself (not of its nested bodies)."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    out = []
    for _, value in ast.iter_fields(stmt):
        for v in value if isinstance(value, list) else [value]:
            if isinstance(v, ast.expr):
                out.append(v)
            elif isinstance(v, ast.withitem):
                out.append(v.context_expr)
    return out


def _own_blocks(stmt: ast.stmt):
    """The statement lists nested in ``stmt``."""
    out = []
    for name in ("body", "orelse", "finalbody"):
        body = getattr(stmt, name, None)
        if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
            out.append(body)
    for h in getattr(stmt, "handlers", []) or []:
        out.append(h.body)
    return out


# ---------------------------------------------------------------------------
# nondeterminism
# ---------------------------------------------------------------------------

_BANNED_CALLS = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "time_ns"), ("time", "sleep"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("os", "urandom"), ("uuid", "uuid4"), ("uuid", "uuid1"),
}


class _NondeterminismVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[LintFinding] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            parent = f.value
            if isinstance(parent, ast.Name):
                pair = (parent.id, f.attr)
                if pair in _BANNED_CALLS:
                    self.findings.append(LintFinding(
                        "nondeterminism", self.path, node.lineno,
                        f"{parent.id}.{f.attr}() in an engine path — "
                        f"simulation results must be a pure function of "
                        f"config + traces + seed"))
                elif parent.id == "random" and f.attr != "Random":
                    # module-level random.* shares hidden global state;
                    # a seeded random.Random(seed) instance is fine
                    self.findings.append(LintFinding(
                        "nondeterminism", self.path, node.lineno,
                        f"module-level random.{f.attr}() — use a seeded "
                        f"random.Random(seed) instance"))
            elif (isinstance(parent, ast.Attribute)
                  and isinstance(parent.value, ast.Name)):
                if (parent.value.id in ("np", "numpy")
                        and parent.attr == "random"):
                    self.findings.append(LintFinding(
                        "nondeterminism", self.path, node.lineno,
                        f"np.random.{f.attr}() uses the hidden global "
                        f"RNG — thread a seeded generator instead"))
                if (parent.value.id == "datetime"
                        and f.attr in ("now", "utcnow", "today")):
                    self.findings.append(LintFinding(
                        "nondeterminism", self.path, node.lineno,
                        f"datetime.{parent.attr}.{f.attr}() in an "
                        f"engine path"))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# interconnect-purity
# ---------------------------------------------------------------------------

#: modules whose mere import is a determinism hazard in the
#: interconnect package (delivery cycles must be a pure function of
#: config + trace — even a seeded PRNG is banned here)
_PURITY_BANNED_MODULES = {"random", "time", "datetime", "uuid", "secrets"}


class _InterconnectPurityVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[LintFinding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(LintFinding(
            "interconnect-purity", self.path, node.lineno,
            f"{what} in hpa2_tpu_torch/interconnect/ — delivery delays must "
            f"be a pure function of config + trace (no clocks, no RNG; "
            f"even a seeded random.Random is banned here)"))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            top = alias.name.split(".")[0]
            if top in _PURITY_BANNED_MODULES:
                self._flag(node, f"import {alias.name}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        top = (node.module or "").split(".")[0]
        if top in _PURITY_BANNED_MODULES:
            self._flag(node, f"from {node.module} import ...")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # catches uses that dodge the import scan (e.g. np.random.*)
        if isinstance(node.value, ast.Name) and (
            node.value.id in _PURITY_BANNED_MODULES
            or (node.value.id in ("np", "numpy") and node.attr == "random")
        ):
            self._flag(node, f"{node.value.id}.{node.attr}")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# dtype-drift
# ---------------------------------------------------------------------------


class _DtypeDriftVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[LintFinding] = []

    def visit_Call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg == "dtype" and isinstance(kw.value, ast.Name) \
                    and kw.value.id in ("int", "float"):
                self.findings.append(LintFinding(
                    "dtype-drift", self.path, node.lineno,
                    f"dtype={kw.value.id} is platform-width — spell "
                    f"out the 32-bit dtype"))
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "astype" \
                and node.args and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in ("int", "float"):
            self.findings.append(LintFinding(
                "dtype-drift", self.path, node.lineno,
                f"astype({node.args[0].id}) is platform-width — spell "
                f"out the 32-bit dtype"))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# dtype-widening (packed state planes)
# ---------------------------------------------------------------------------

#: the packed uint8/uint16 state planes (ops/layout.py ``_PACKED_CACHE``
#: + ``_PACKED_DIR``), plus their snapshot twins
PACKED_PLANES = frozenset(
    p for base in ("cvalw", "cmetaw", "dmemw", "dmetaw")
    for p in (base, f"snap_{base}")
)
#: the only functions allowed to do arithmetic on packed planes: the
#: in-kernel widen/narrow pairs and the host-side numpy converters
SANCTIONED_WIDENERS = frozenset({
    "_widen", "_narrow",
    "_widen_cache", "_narrow_cache", "_widen_dir", "_narrow_dir",
    "_split_word_planes_np", "_join_word_planes_np",
})


class _DtypeWideningVisitor(ast.NodeVisitor):
    """Flags arithmetic on packed-plane reads outside the sanctioned
    widen/narrow helpers.  A packed-plane read is a Name spelled like
    the plane or a ``Constant``-string subscript of one (``s["cvalw"]``);
    structural ops (gather/where/stack/indexing) pass through
    untouched, so only BinOp/Compare/UnaryOp — and a stray
    ``.astype`` — count as promotion sites."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[LintFinding] = []

    def visit_FunctionDef(self, fn: ast.FunctionDef) -> None:
        if fn.name in SANCTIONED_WIDENERS:
            return  # the audited promotion sites
        self.generic_visit(fn)

    visit_AsyncFunctionDef = visit_FunctionDef

    @classmethod
    def _packed_read(cls, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in PACKED_PLANES:
            return node.id
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in PACKED_PLANES:
                return sl.value
        return None

    @classmethod
    def _find_packed_read(cls, expr: ast.AST) -> Optional[str]:
        hit = cls._packed_read(expr)
        if hit:
            return hit
        # a call boundary hands the plane to a callee (usually a
        # sanctioned helper) — the callee body is scanned on its own,
        # so the argument read itself is not a promotion
        if isinstance(expr, ast.Call):
            return None
        for child in ast.iter_child_nodes(expr):
            hit = cls._find_packed_read(child)
            if hit:
                return hit
        return None

    def _flag(self, node: ast.AST, plane: str, what: str) -> None:
        self.findings.append(LintFinding(
            "dtype-widening", self.path, node.lineno,
            f"{what} on packed plane {plane!r} outside the sanctioned "
            f"_widen*/_narrow* helpers — the uint8/uint16 plane "
            f"silently promotes to int32 in the kernel body"))

    def visit_BinOp(self, node: ast.BinOp) -> None:
        for side in (node.left, node.right):
            hit = self._find_packed_read(side)
            if hit:
                self._flag(node, hit, "arithmetic")
                break
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        for side in [node.left] + list(node.comparators):
            hit = self._find_packed_read(side)
            if hit:
                self._flag(node, hit, "comparison")
                break
        self.generic_visit(node)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, (ast.Invert, ast.USub)):
            hit = self._find_packed_read(node.operand)
            if hit:
                self._flag(node, hit, "arithmetic")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "astype":
            hit = self._find_packed_read(f.value) or self._packed_read(
                f.value
            )
            if hit:
                self._flag(node, hit, "astype")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# dead-handler (spec_engine dispatch registration)
# ---------------------------------------------------------------------------


class _HandWrittenStateVisitor(ast.NodeVisitor):
    """Ban hand-written protocol state constants in the general
    engine's step and the fast path's cycle.  Those modules resolve
    every cache/directory state through the compiled ``ProtocolPlanes``
    (hpa2_tpu_torch/protocols/compiler.py) or the layout's constants,
    so the TransitionTable stays the single source of truth; a
    ``CacheState.MODIFIED`` literal here is a second, silently
    divergent copy of the protocol."""

    _BANNED = ("CacheState", "DirState")

    def __init__(self, path: str):
        self.path = path
        self.findings: List[LintFinding] = []

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            if alias.name in self._BANNED:
                self.findings.append(LintFinding(
                    "hand-written-state", self.path, node.lineno,
                    f"imports {alias.name} — kernel state constants "
                    f"must come from the compiled ProtocolPlanes "
                    f"(hpa2_tpu_torch/protocols), not the enums"))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name)
                and node.value.id in self._BANNED):
            self.findings.append(LintFinding(
                "hand-written-state", self.path, node.lineno,
                f"hand-written state constant {node.value.id}."
                f"{node.attr} — use the compiled ProtocolPlanes "
                f"lookup instead"))
        self.generic_visit(node)


#: ops modules that must be fully plane-driven (relative paths)
_PLANE_DRIVEN = (
    os.path.join("hpa2_tpu_torch", "ops", "step.py"),
    os.path.join("hpa2_tpu_torch", "ops", "cycle.py"),
)


def _lint_dispatch(path: str, tree: ast.Module) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name == "SpecEngine"):
            continue
        handlers = {
            m.name for m in cls.body
            if isinstance(m, ast.FunctionDef) and m.name.startswith("_on_")
        }
        registered: Set[str] = set()
        dispatched_types: Set[str] = set()
        dispatch_line = cls.lineno
        for item in cls.body:
            if isinstance(item, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_DISPATCH"
                for t in item.targets
            ) and isinstance(item.value, ast.Dict):
                dispatch_line = item.lineno
                for k, v in zip(item.value.keys, item.value.values):
                    if isinstance(v, ast.Constant) and isinstance(
                        v.value, str
                    ):
                        registered.add(v.value)
                    if isinstance(k, ast.Attribute):
                        dispatched_types.add(k.attr)
        if not registered:
            findings.append(LintFinding(
                "dead-handler", path, dispatch_line,
                "SpecEngine has no _DISPATCH dict literal — handler "
                "registration is not statically checkable"))
            continue
        for h in sorted(handlers - registered):
            findings.append(LintFinding(
                "dead-handler", path, dispatch_line,
                f"handler method {h} is not registered in _DISPATCH — "
                f"dead code that looks like protocol coverage"))
        for r in sorted(registered - handlers):
            findings.append(LintFinding(
                "dead-handler", path, dispatch_line,
                f"_DISPATCH registers {r} but SpecEngine defines no "
                f"such method"))
        try:
            from hpa2_tpu_torch.models.protocol import MsgType
            missing = {m.name for m in MsgType} - dispatched_types
        except Exception:  # pragma: no cover — protocol must import
            missing = set()
        for m in sorted(missing):
            findings.append(LintFinding(
                "dead-handler", path, dispatch_line,
                f"MsgType.{m} has no _DISPATCH entry — the message "
                f"would hit the unknown-type assertion at runtime"))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _is_engine_path(rel: str) -> bool:
    return any(rel.startswith(d + os.sep) for d in ENGINE_DIRS)


def _is_ops_path(rel: str) -> bool:
    return rel.startswith(OPS_DIR + os.sep)


def lint_file(repo_root: str, rel: str) -> List[LintFinding]:
    path = os.path.join(repo_root, rel)
    with open(path, "r") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [LintFinding("parse", rel, e.lineno or 0, str(e))]
    findings: List[LintFinding] = []
    if _is_engine_path(rel):
        v = _NondeterminismVisitor(rel)
        v.visit(tree)
        findings.extend(v.findings)
    if rel.startswith(INTERCONNECT_DIR + os.sep):
        ip = _InterconnectPurityVisitor(rel)
        ip.visit(tree)
        findings.extend(ip.findings)
    scope = HOST_SYNC_SCOPE.get(rel)
    if scope:
        hs = _HostSyncVisitor(rel, scope)
        hs.visit_module(tree)
        findings.extend(hs.findings)
    if _is_ops_path(rel):
        dd = _DtypeDriftVisitor(rel)
        dd.visit(tree)
        findings.extend(dd.findings)
        dw = _DtypeWideningVisitor(rel)
        dw.visit(tree)
        findings.extend(dw.findings)
    if rel.endswith(os.path.join("models", "spec_engine.py")):
        findings.extend(_lint_dispatch(rel, tree))
    if any(rel.endswith(p) or rel == p for p in _PLANE_DRIVEN):
        hs = _HandWrittenStateVisitor(rel)
        hs.visit(tree)
        findings.extend(hs.findings)
    return findings


# ---------------------------------------------------------------------------
# counter-backfill (cross-file: ops/engine.py stats vs utils/checkpoint.py)
# ---------------------------------------------------------------------------

_STATS_FILE = os.path.join("hpa2_tpu_torch", "ops", "engine.py")
_CHECKPOINT_FILE = os.path.join("hpa2_tpu_torch", "utils", "checkpoint.py")


def _is_st_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "st")


def _stats_optional_fields(tree: ast.Module):
    """SimState fields feeding only-when-nonzero keys in
    ``engine_stats``: every ``st.<field>`` the function reads OUTSIDE
    the always-present ``core = {...}`` literal (``msg_counts`` is an
    original schema-v1 plane, exempt).  Returns {field: lineno} or
    None when the function is missing."""
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)
               and n.name == "engine_stats"), None)
    if fn is None:
        return None
    always: Set[str] = {"msg_counts"}
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Assign)
                and len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Name)
                and sub.targets[0].id == "core"
                and isinstance(sub.value, ast.Dict)):
            for v in ast.walk(sub.value):
                if _is_st_attr(v):
                    always.add(v.attr)
    fields = {}
    for sub in ast.walk(fn):
        if _is_st_attr(sub) and sub.attr not in always:
            fields.setdefault(sub.attr, sub.lineno)
    return fields


def _checkpoint_backfill(tree: ast.Module) -> Optional[Set[str]]:
    """The names in checkpoint.py's ``_ZERO_BACKFILL`` frozenset
    literal, or None when the assignment is missing."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_ZERO_BACKFILL"):
            return {
                c.value for c in ast.walk(node.value)
                if isinstance(c, ast.Constant)
                and isinstance(c.value, str)
            }
    return None


def lint_counter_backfill(repo_root: str) -> List[LintFinding]:
    """Cross-file rule: only-when-nonzero stats counters must be
    checkpoint-backfilled.  Zero findings when either file is absent
    (synthetic lint-test roots carry only the files they probe)."""
    paths = {}
    for rel in (_STATS_FILE, _CHECKPOINT_FILE):
        full = os.path.join(repo_root, rel)
        if not os.path.isfile(full):
            return []
        with open(full, "r") as f:
            try:
                paths[rel] = ast.parse(f.read(), filename=rel)
            except SyntaxError:
                return []  # the per-file pass reports the parse error
    fields = _stats_optional_fields(paths[_STATS_FILE])
    if fields is None:
        return [LintFinding(
            "counter-backfill", _STATS_FILE, 0,
            "engine_stats() not found — the counter-backfill rule "
            "needs updating for the new stats entry point")]
    backfill = _checkpoint_backfill(paths[_CHECKPOINT_FILE])
    if backfill is None:
        return [LintFinding(
            "counter-backfill", _CHECKPOINT_FILE, 0,
            "_ZERO_BACKFILL frozenset not found — the checkpoint "
            "loader lost its telemetry-counter backfill")]
    return [
        LintFinding(
            "counter-backfill", _STATS_FILE, lineno,
            f"optional stats counter reads st.{field} but "
            f"utils/checkpoint.py::_ZERO_BACKFILL does not backfill "
            f"{field!r} — checkpoints written before the counter "
            f"existed become unloadable")
        for field, lineno in sorted(fields.items())
        if field not in backfill
    ]


def default_targets(repo_root: str) -> List[str]:
    out: List[str] = []
    for d in ENGINE_DIRS:
        full = os.path.join(repo_root, d)
        if not os.path.isdir(full):
            # synthetic lint-test roots carry only the dirs they probe
            continue
        for name in sorted(os.listdir(full)):
            if name.endswith(".py"):
                out.append(os.path.join(d, name))
    return out


def run_lint(repo_root: str, targets: Optional[Iterable[str]] = None
             ) -> List[LintFinding]:
    rels = list(targets) if targets is not None else default_targets(repo_root)
    findings: List[LintFinding] = []
    for rel in rels:
        findings.extend(lint_file(repo_root, rel))
    findings.extend(lint_counter_backfill(repo_root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
