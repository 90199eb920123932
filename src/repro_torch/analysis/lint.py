"""Layer 2: AST lint of the port's source tree (rules R001-R005; PyTorch
port of ``repro/analysis/lint.py``).

A pure ``ast`` walk over every ``*.py`` of the ``repro_torch`` package
under the source root: nothing linted is imported, so it runs in
milliseconds and works on fixture trees in tests.  Each rule encodes one
contract of the port that a run of its programs cannot see:

  R001  raw ``+/-1e30`` sentinel literals outside ``kernels/ops.py``:
        the masking sentinel has one home, ``kernels.ops.INVALID_SCORE``.
  R002  the removed ``WorkSet`` / ``GramCache`` / ``driver.run`` names,
        anywhere, and the retired ``repro_torch/core/workset.py`` module.
  R003  a direct ``torch.distributed`` collective (``dist.all_reduce``,
        ``dist.all_gather*``, ...) inside :mod:`repro_torch.shard`:
        collectives go through ``CollectiveTrace`` and ``DataMesh``
        (``shard/telemetry.py``, ``launch/mesh.py``), which count them,
        or the program layer's budgets lie.
  R004  implicit host syncs inside engine/kernel hot-path functions:
        ``float()``, ``np.asarray()``, ``.item()``, ``.tolist()``,
        ``.cpu()``, ``.numpy()``, ``.synchronize()``,
        ``.block_until_ready()``, and a blocking upload from pageable
        memory: ``torch.as_tensor``/``torch.tensor`` with ``device=``, or
        ``torch.from_numpy(...).to(...)`` without ``non_blocking=True``
        (use ``core.types.upload``).  Constructors and
        module level are host-side by definition and exempt.
  R005  ``torch.float64`` / ``torch.double`` / ``dtype="float64"`` /
        ``.double()`` in device code (fp32 accumulation discipline;
        host-side ``np.float64`` bookkeeping is fine).

A finding on line N is suppressed by an inline waiver on that line:

    ids = np.asarray(perm)  # repro: allow[R004] host permutation

The waiver names the rule(s) it waives and carries a reason.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

# The sentinel magnitude R001 polices, spelled without its own literal so
# this file never trips the rule it implements.
_SENTINEL = float("1e30")

#: The package this lint covers, under the source root.
PACKAGE = "repro_torch"

#: rule -> files (relative, posix) the rule does NOT apply to: the
#: sentinel's home, the collective counters.
ALLOWED: Dict[str, Tuple[str, ...]] = {
    "R001": ("repro_torch/kernels/ops.py",),
    "R003": ("repro_torch/shard/telemetry.py",
             "repro_torch/launch/mesh.py"),
}

#: R002 existence check: shim modules that must not exist.
_RETIRED_MODULES = ("repro_torch/core/workset.py",)

#: R003 scope: the shard engine package.
_SHARD_SCOPE = ("repro_torch/shard/",)

#: R004 scope: hot-path modules, where every statement of a function is
#: on the dispatch path.
_HOT_SCOPE = ("repro_torch/kernels/", "repro_torch/shard/",
              "repro_torch/core/mpbcfw.py", "repro_torch/core/bcfw.py",
              "repro_torch/core/distributed.py")

#: R005 scope: device code (kernels, optimizer cores, model stacks).
_DEVICE_SCOPE = ("repro_torch/kernels/", "repro_torch/core/",
                 "repro_torch/shard/", "repro_torch/cache/",
                 "repro_torch/models/")

_WAIVER_RE = re.compile(
    r"#\s*repro:\s*allow\[([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\]")

# Methods whose call waits for the device.
_HOST_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize",
                    "block_until_ready")

# torch.distributed collectives (R003).
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "broadcast", "reduce", "gather", "scatter")


def _in_scope(rel: str, scope: Sequence[str]) -> bool:
    return any(rel == s or rel.startswith(s) for s in scope)


def _allowed(rel: str, rule: str) -> bool:
    return _in_scope(rel, ALLOWED.get(rule, ()))


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _keyword(node: ast.Call, name: str) -> Optional[ast.keyword]:
    return next((k for k in node.keywords if k.arg == name), None)


def parse_waivers(text: str) -> Dict[int, Set[str]]:
    """line number (1-based) -> waived rule ids on that line."""
    waivers: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m is not None:
            waivers[i] = {r.strip() for r in m.group(1).split(",")}
    return waivers


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, waivers: Dict[int, Set[str]]):
        self.rel = rel
        self.waivers = waivers
        self.findings: List[Finding] = []
        self._funcs: List[str] = []   # enclosing function-name stack

    # -- plumbing ---------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.waivers.get(line, ()):
            return
        if _allowed(self.rel, rule):
            return
        self.findings.append(Finding(rule, f"{self.rel}:{line}", message))

    def _in_hot_function(self) -> bool:
        """Inside a function body that is not a constructor."""
        return bool(self._funcs) and "__init__" not in self._funcs

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- R001: raw sentinel literals --------------------------------------

    def visit_Constant(self, node: ast.Constant) -> None:
        v = node.value
        if isinstance(v, float) and abs(v) == _SENTINEL:
            self._emit("R001", node,
                       "raw sentinel literal; use "
                       "repro_torch.kernels.ops.INVALID_SCORE")
        self.generic_visit(node)

    # -- R002: removed names ----------------------------------------------

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in ("WorkSet", "GramCache"):
            self._emit("R002", node,
                       f"removed {node.id}; use repro_torch.cache."
                       "PlaneCache"
                       + (" (gram blocks live inside the cache)"
                          if node.id == "GramCache" else ""))
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            if alias.name in ("WorkSet", "GramCache"):
                self._emit("R002", node,
                           f"import of removed {alias.name} "
                           f"from {mod!r}")
            elif alias.asname in ("WorkSet", "GramCache"):
                self._emit("R002", node,
                           f"import aliased to removed {alias.asname}")
            if alias.name == "run" and mod.split(".")[-1] == "driver":
                self._emit("R002", node,
                           "removed driver.run; use repro_torch.api.Solver")
        self.generic_visit(node)

    # -- attribute-shaped rules -------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        base = _dotted(node.value)
        # R002: driver.run
        if node.attr == "run" and base == "driver":
            self._emit("R002", node,
                       "removed driver.run; use repro_torch.api.Solver")
        # R003: a direct collective in the shard package
        if (node.attr in _COLLECTIVES
                and base in ("dist", "torch.distributed")
                and _in_scope(self.rel, _SHARD_SCOPE)):
            self._emit("R003", node,
                       f"direct {base}.{node.attr} in repro_torch.shard; "
                       "route it through CollectiveTrace / DataMesh so "
                       "the collective budgets stay counted")
        # R005: float64 dtype in device code
        if (node.attr in ("float64", "double") and base == "torch"
                and _in_scope(self.rel, _DEVICE_SCOPE)):
            self._emit("R005", node,
                       f"torch.{node.attr} in device code; dual "
                       "accumulation is float32 "
                       "(EngineCapabilities.accum_dtype)")
        self.generic_visit(node)

    # -- R004 (and R005's .double()): calls -------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr == "double"
                and not node.args and not node.keywords
                and _in_scope(self.rel, _DEVICE_SCOPE)):
            self._emit("R005", node,
                       ".double() in device code; accumulation is float32")
        if _in_scope(self.rel, _HOT_SCOPE) and self._in_hot_function():
            self._host_sync(node, fn)
        self.generic_visit(node)

    def _host_sync(self, node: ast.Call, fn: ast.AST) -> None:
        if isinstance(fn, ast.Name) and fn.id == "float":
            self._emit("R004", node,
                       "float() on a device value blocks the dispatch "
                       "pipeline (implicit host sync)")
            return
        if not isinstance(fn, ast.Attribute):
            return
        base = _dotted(fn.value)
        if fn.attr == "asarray" and base in ("np", "numpy"):
            self._emit("R004", node,
                       "np.asarray() fetches the device buffer (implicit "
                       "host sync)")
        elif fn.attr in _HOST_SYNC_ATTRS:
            self._emit("R004", node, f".{fn.attr}() is an implicit host "
                       "sync")
        elif (fn.attr in ("as_tensor", "tensor") and base == "torch"
              and _keyword(node, "device") is not None):
            self._emit("R004", node,
                       f"torch.{fn.attr}(..., device=) copies from "
                       "pageable memory and waits for the device; use "
                       "core.types.upload")
        elif (fn.attr == "to" and isinstance(fn.value, ast.Call)
              and _dotted(fn.value.func) == "torch.from_numpy"
              and not _non_blocking(node)):
            self._emit("R004", node,
                       "torch.from_numpy(...).to(...) without "
                       "non_blocking=True waits for the device; use "
                       "core.types.upload")

    # -- R005: string dtype spellings -------------------------------------

    def visit_keyword(self, node: ast.keyword) -> None:
        if (node.arg == "dtype" and isinstance(node.value, ast.Constant)
                and node.value.value in ("float64", "double")
                and _in_scope(self.rel, _DEVICE_SCOPE)):
            self._emit("R005", node.value,
                       f"dtype={node.value.value!r} in device code; "
                       "accumulation is float32")
        self.generic_visit(node)


def _non_blocking(node: ast.Call) -> bool:
    k = _keyword(node, "non_blocking")
    return (k is not None and isinstance(k.value, ast.Constant)
            and k.value.value is True)


def lint_source(rel: str, text: str) -> List[Finding]:
    """Lint one file's source.  ``rel`` is its path relative to the
    source root (posix separators): rule scoping keys off it."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("R000", f"{rel}:{e.lineno or 0}",
                        f"syntax error: {e.msg}")]
    linter = _Linter(rel, parse_waivers(text))
    linter.visit(tree)
    return linter.findings


def default_root() -> Path:
    """The repo's ``src/`` directory (this package's grandparent)."""
    return Path(__file__).resolve().parents[2]


def run_lint_layer(root: Optional[Path] = None) -> List[Finding]:
    """Lint every ``*.py`` of the ``repro_torch`` package under the
    source root ``root`` (default: the repo's ``src/``, so
    ``src/repro_torch/``)."""
    root = default_root() if root is None else Path(root)
    findings: List[Finding] = []
    for rel in _RETIRED_MODULES:
        if (root / rel).exists():
            findings.append(Finding(
                "R002", f"{rel}:1",
                "retired shim module still exists; delete it"))
    for path in sorted((root / PACKAGE).rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        findings.extend(lint_source(rel, path.read_text()))
    return findings
