"""The port's AST linter: the reference's REPRO rule set
(``repro.analysis.lint``) in torch terms, over the port's hot paths.

REPRO001  host sync in a hot scope - ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, or ``float()`` / ``int()`` /
          ``bool()`` / ``np.asarray()`` of a tensor.  On the card the
          read waits for the stream, and inside a CUDA graph capture it
          fails; in a decode or search loop it stalls every iteration.
REPRO002  wall-clock timing around asynchronous CUDA work - a
          ``time.time()`` / ``perf_counter()`` / ``monotonic()`` pair
          bracketing CUDA work with no fence between the two reads
          (``torch.cuda.synchronize``, a stream's or event's
          ``.synchronize()``, ``elapsed_time``, ``block_until_ready``,
          ``obs.timer`` / ``obs.span``, or a host read: any ``float()`` /
          ``int()`` / ``bool()`` of a non-constant counts, as the linter
          cannot tell a tensor from a number there): the delta measures
          the launches, not the work.
REPRO003  silent fallback branch - an ``except`` handler that neither
          raises, warns (``warnings.warn`` / ``obs.log`` / logging),
          fails a check (``check(...)`` / ``fail(...)``, chip_smoke.py's
          own), nor carries a comment saying why: no fallback may hide
          the device or the kernel.
REPRO004  host numpy in a ``kernels/`` wrapper's launch path - a
          function under ``kernels/`` that counts its launches
          (``<wrapper>.launches += 1``) or is named ``*_kernel``: numpy
          there copies the operands to the host on every launch.
REPRO006  zipped tree leaves - ``zip(tree.leaves(a), tree.leaves(b))``
          without ``strict=True`` silently truncates when the trees
          differ; use ``tree.tree_map`` or ``zip(..., strict=True)``.
REPRO007  clobbered environment flag - ``os.environ[F] = ...`` for F in
          ``XLA_FLAGS``, ``TORCH_CUDA_ARCH_LIST``, ``NVCC_APPEND_FLAGS``,
          ``CUDA_VISIBLE_DEVICES``, with a value that never reads the
          environment, drops what the user set before launch; fold the
          old value in (``os.environ.get(F, "") + ...``).

REPRO005 (an unhashable literal passed as a jit static argument) has no
torch counterpart: nothing in the port is jitted with static arguments,
so the number is left unused.

**Hot scopes** (REPRO001).  The linter follows no call; a scope is hot
when one of these holds, each read off the source by
:func:`hot_scopes`, which the tests check against the port's tree:

* the statements inside a ``with torch.cuda.graph(...)`` block, in any
  module;
* in a module ending ``serve/engine.py``: every function (``def`` or
  ``lambda``) passed as an argument to ``_call(...)`` or ``_Graph(...)``
  - the bodies ``EngineFns`` captures as CUDA graphs (decode, draft,
  verify);
* in a module ending ``models/model.py``: ``decode_step`` and
  ``verify_step``, the bodies of those graphs;
* in a module ending ``core/calibrate.py``: the ``for`` / ``while``
  loops of ``run_search``, the search loop (its single read after the
  loop is not hot).

The four methods count whatever their receiver; ``float()`` /
``int()`` / ``bool()`` / ``np.asarray()`` count when their argument is a
tensor.  A value is a tensor when it is a call of ``torch.*`` (not a
``torch.cuda`` query, a dtype or a device); a parameter annotated
``torch.Tensor``; or a name last bound, in the same function, to a
tensor, a method call or subscript of one, arithmetic with one, or the
result of a step function (below).

**CUDA work** (REPRO002) between the two clock reads is a call of
``torch.*`` (other than a fence or ``torch.cuda`` queries), a kernel
wrapper imported from ``repro_torch.kernels``, or a step function bound
from ``make_train_step`` / ``make_prefill`` / ``make_decode`` /
``make_search_step`` in the same function.

Suppression: ``# noqa`` or ``# noqa: REPRO001[,REPRO006]`` on the
offending line, with its reason after it.  Standard library only (no
torch, no numpy), so it runs before anything heavy is installed:

    python -m repro_torch.analysis lint src/repro_torch chip_smoke.py
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import sys

RULES = {
    "REPRO001": "host sync inside a hot scope (graph body, decode/verify "
                "step, search loop)",
    "REPRO002": "wall-clock timing around CUDA work without a fence",
    "REPRO003": "silent fallback branch (except with no warn/raise/check/"
                "comment)",
    "REPRO004": "host numpy inside a kernels/ wrapper's launch path",
    "REPRO006": "zip over tree leaves without strict=True",
    "REPRO007": "assignment clobbers an environment flag the user set",
}

# module path suffix -> what is hot there (see the module docstring)
HOT = {
    "serve/engine.py": {"capture": {"_call", "_Graph"}},
    "models/model.py": {"defs": {"decode_step", "verify_step"}},
    "core/calibrate.py": {"loops": {"run_search"}},
}
ENV_FLAGS = {"XLA_FLAGS", "TORCH_CUDA_ARCH_LIST", "NVCC_APPEND_FLAGS",
             "CUDA_VISIBLE_DEVICES"}

_TREE_LEAVES = {"jax.tree.leaves", "tree.leaves", "jax.tree_util.tree_leaves",
                "tree_util.tree_leaves"}
_CLOCK_NAMES = {"time.time", "time.perf_counter", "time.monotonic"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"float", "int", "bool"}
_NP_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_FENCE_ATTRS = {"synchronize", "elapsed_time", "block_until_ready"}
_FENCE_CALLS = {"obs.timer", "obs.span"}
# torch calls that return no tensor
_NOT_TENSOR = ("torch.cuda.", "torch.backends.", "torch.get_", "torch.is_",
               "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
               "torch.Size", "torch.Generator", "torch.set_")
_STEP_MAKERS = {"make_train_step", "make_prefill", "make_decode",
                "make_search_step"}
_WARN_CALLS = {"warnings.warn", "obs.log"}
_WARN_ATTRS = {"warn", "log", "error", "warning", "exception", "info"}
_CHECK_CALLS = {"check", "fail"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute chains, 'float' for Names,
    '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _target_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _target_names(elt)]
    return []


def _suffix(path: str) -> str:
    posix = pathlib.PurePath(path).as_posix()
    for key in HOT:
        if posix.endswith(key):
            return key
    return ""


def _is_graph_with(node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and _dotted(it.context_expr.func) == "torch.cuda.graph"
        for it in node.items)


def hot_scopes(src: str, path: str = "<string>") -> dict[str, list]:
    """The hot scopes of one module, by the rules of the module docstring:
    ``{"graph": [lines of torch.cuda.graph blocks], "captured": [lines of
    captured function defs / lambdas], "defs": [hot function names],
    "loops": [functions whose loops are hot]}``."""
    scopes = _scan(ast.parse(src), _suffix(path))
    return {"graph": sorted(n.lineno for n in scopes["graph"]),
            "captured": sorted(n.lineno for n in scopes["captured"]),
            "defs": sorted(n.name for n in scopes["defs"]),
            "loops": sorted(n.name for n in scopes["loops"])}


def _scan(tree: ast.AST, suffix: str) -> dict[str, set]:
    rules = HOT.get(suffix, {})
    out = {"graph": set(), "captured": set(), "defs": set(), "loops": set()}
    defs_by_name: dict[str, list] = {}
    passed: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
            if node.name in rules.get("defs", ()):
                out["defs"].add(node)
            if node.name in rules.get("loops", ()):
                out["loops"].add(node)
        if _is_graph_with(node):
            out["graph"].add(node)
        if isinstance(node, ast.Call) and rules.get("capture") and (
                _dotted(node.func).split(".")[-1] in rules["capture"]):
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Name):
                    passed.add(a.id)
                elif isinstance(a, ast.Lambda):
                    out["captured"].add(a)
    for name in passed:
        out["captured"].update(defs_by_name.get(name, ()))
    return out


class _Linter:
    def __init__(self, path: str, lines: list[str], scopes: dict,
                 in_kernels: bool, kernel_names: set[str]):
        self.path, self.lines, self.scopes = path, lines, scopes
        self.in_kernels = in_kernels
        self.kernel_names = kernel_names
        self.findings: list[Finding] = []

    def _suppressed(self, line: int, rule: str) -> bool:
        if 1 <= line <= len(self.lines):
            text = self.lines[line - 1]
            if "noqa" in text:
                _, _, tail = text.partition("noqa")
                tail = tail.strip()
                if not tail.startswith(":"):
                    return True      # blanket noqa
                return rule in tail
        return False

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        line = getattr(node, "lineno", 0)
        if not self._suppressed(line, rule):
            self.findings.append(Finding(self.path, line,
                                         getattr(node, "col_offset", 0),
                                         rule, msg))

    # -- one function scope ----------------------------------------------

    def run(self, fnode, hot: bool) -> None:
        hot = hot or fnode in self.scopes["captured"] \
            or fnode in self.scopes["defs"]
        loop_hot = fnode in self.scopes["loops"]
        launch_path = self.in_kernels and self._is_launch_path(fnode)
        tensors = self._annotated_tensors(fnode)
        steps: set[str] = set()
        clocks: dict[str, int] = {}
        work: list[int] = []
        fences: list[int] = []
        nested: list = []
        body = fnode.body if isinstance(fnode.body, list) else [fnode.body]

        def walk(node, in_loop, in_graph):
            if node is not fnode and isinstance(node, _FUNCS):
                nested.append((node, hot or in_graph))
                return
            if isinstance(node, ast.Assign):
                self._bind(node, tensors, steps, clocks)
            if isinstance(node, ast.Call):
                self._check_call(node, hot or in_graph or (
                    loop_hot and in_loop), launch_path, tensors, steps,
                    work, fences)
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                self._check_clock_delta(node, clocks, work, fences)
            if isinstance(node, ast.ExceptHandler):
                self._check_except(node)
            loop = isinstance(node, (ast.For, ast.While, ast.AsyncFor))
            graph = node in self.scopes["graph"]
            for child in ast.iter_child_nodes(node):
                walk(child, in_loop or loop, in_graph or graph)

        for stmt in body:
            walk(stmt, False, False)
        for sub, sub_hot in nested:
            self.run(sub, sub_hot)

    @staticmethod
    def _annotated_tensors(fnode) -> set[str]:
        if isinstance(fnode, ast.Lambda):
            return set()
        args = fnode.args
        return {a.arg for a in args.posonlyargs + args.args
                + args.kwonlyargs
                if a.annotation is not None
                and "Tensor" in ast.unparse(a.annotation)}

    def _is_tensor(self, node: ast.AST, tensors: set[str]) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                d = _dotted(n.func)
                if d.startswith(("torch.", "F.")) and not d.startswith(
                        _NOT_TENSOR):
                    return True
            if isinstance(n, ast.Name) and n.id in tensors:
                return True
        return False

    def _bind(self, node: ast.Assign, tensors, steps, clocks) -> None:
        names = [n for t in node.targets for n in _target_names(t)]
        v = node.value
        if isinstance(v, ast.Call):
            d = _dotted(v.func)
            if d in _CLOCK_NAMES:
                clocks.update({n: node.lineno for n in names})
            if d.split(".")[-1] in _STEP_MAKERS:
                steps.update(names)
        from_step = isinstance(v, ast.Call) and _dotted(v.func) in steps
        if (from_step or self._is_tensor(v, tensors)) and \
                not self._is_host_read(v):
            tensors.update(names)
        else:
            tensors.difference_update(names)

    @staticmethod
    def _is_host_read(v: ast.AST) -> bool:
        """A value the host holds after the call: a sync's result."""
        if isinstance(v, ast.Call):
            if isinstance(v.func, ast.Attribute) and \
                    v.func.attr in _SYNC_METHODS:
                return True
            if _dotted(v.func) in _SYNC_CALLS | _NP_SYNC:
                return True
        return False

    def _is_launch_path(self, fnode) -> bool:
        if isinstance(fnode, ast.Lambda):
            return False
        if fnode.name.endswith("_kernel"):
            return True
        return any(isinstance(n, ast.AugAssign)
                   and isinstance(n.target, ast.Attribute)
                   and n.target.attr == "launches"
                   for n in ast.walk(fnode))

    # -- rules -------------------------------------------------------------

    def _sync_of(self, node: ast.Call, tensors) -> str:
        """The sync a call makes on a tensor ('' if none)."""
        d = _dotted(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args:
            # whatever the receiver: in the port these four methods are
            # called on tensors (and host arrays, which are no hot scope's)
            return f".{node.func.attr}()"
        if d in _SYNC_CALLS | _NP_SYNC and node.args and \
                self._is_tensor(node.args[0], tensors):
            return f"{d}()"
        return ""

    def _check_call(self, node: ast.Call, hot: bool, launch_path: bool,
                    tensors, steps, work, fences) -> None:
        d = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        sync = self._sync_of(node, tensors)
        # a float() / int() / bool() of anything but a constant may read a
        # tensor back: a fence for REPRO002 (a sync for REPRO001 only when
        # the argument is known to be a tensor)
        read = d in _SYNC_CALLS and node.args and not isinstance(
            node.args[0], ast.Constant)
        if sync or read or attr in _FENCE_ATTRS or d in _FENCE_CALLS:
            fences.append(node.lineno)
        elif (d.startswith("torch.") and not d.startswith(_NOT_TENSOR)) \
                or d in self.kernel_names or d in steps:
            work.append(node.lineno)

        if sync and hot:
            self._emit(node, "REPRO001",
                       f"`{sync}` reads a tensor to the host in a hot scope "
                       "(a CUDA-graph body, a decode / verify step or the "
                       "search loop); keep it on the device and read once "
                       "outside")
        if launch_path and (d.startswith("np.") or d.startswith("numpy.")):
            self._emit(node, "REPRO004",
                       f"`{d}` in a kernel wrapper's launch path runs on the "
                       "host at every launch; keep the operands on the "
                       "device (torch) or hoist it out of the wrapper")
        if d == "zip":
            leaves = [a for a in node.args if isinstance(a, ast.Call)
                      and _dotted(a.func) in _TREE_LEAVES]
            strict = any(kw.arg == "strict" and
                         isinstance(kw.value, ast.Constant) and
                         kw.value.value is True for kw in node.keywords)
            if len(leaves) >= 2 and not strict:
                self._emit(node, "REPRO006",
                           "zip over tree leaves silently truncates on "
                           "structural divergence; use tree.tree_map or "
                           "zip(..., strict=True)")

    def _check_clock_delta(self, node: ast.BinOp, clocks, work,
                           fences) -> None:
        right = node.right
        if not (isinstance(right, ast.Name) and right.id in clocks):
            return
        left = node.left
        if not ((isinstance(left, ast.Call)
                 and _dotted(left.func) in _CLOCK_NAMES)
                or (isinstance(left, ast.Name) and left.id in clocks)):
            return
        start, stop = clocks[right.id], node.lineno
        if any(start <= ln <= stop for ln in work) and not any(
                start <= ln <= stop for ln in fences):
            self._emit(node, "REPRO002",
                       "clock pair brackets CUDA work with no fence; the "
                       "delta is the launches' time, not the device's "
                       "(torch.cuda.synchronize / an event / obs.timer / a "
                       "host read before the second clock)")

    def _check_except(self, node: ast.ExceptHandler) -> None:
        for stmt in ast.walk(node):
            if isinstance(stmt, ast.Raise):
                return
            if isinstance(stmt, ast.Call):
                d = _dotted(stmt.func)
                if d in _WARN_CALLS or d in _CHECK_CALLS:
                    return
                if isinstance(stmt.func, ast.Attribute) and \
                        stmt.func.attr in _WARN_ATTRS:
                    return
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        for ln in range(node.lineno, min(end, len(self.lines)) + 1):
            if "#" in self.lines[ln - 1]:
                return
        self._emit(node, "REPRO003",
                   "except handler swallows the failure silently; warn "
                   "(obs.log / warnings.warn), raise, fail the check, or "
                   "justify with an inline comment")


def _reads_env(value: ast.AST) -> bool:
    for n in ast.walk(value):
        if isinstance(n, (ast.Attribute, ast.Name)) and \
                _dotted(n) == "os.environ":
            return True
        if isinstance(n, ast.Call) and _dotted(n.func) == "os.getenv":
            return True
    return False


def _check_env_clobber(tree: ast.AST, linter: _Linter) -> None:
    """REPRO007, over the whole module (the assignments usually sit at the
    top level, before an import reads them)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Subscript)
                    and _dotted(t.value) == "os.environ"
                    and isinstance(t.slice, ast.Constant)
                    and t.slice.value in ENV_FLAGS
                    and not _reads_env(node.value)):
                linter._emit(node, "REPRO007",
                             f'assignment to os.environ["{t.slice.value}"] '
                             "drops what the user set; append to "
                             f'os.environ.get("{t.slice.value}", "") '
                             "instead")


def _kernel_imports(tree: ast.AST) -> set[str]:
    """Names imported from ``repro_torch.kernels`` modules (the wrappers;
    not the build's private ``_build``)."""
    out = set()
    for node in ast.walk(tree):
        mod = (node.module or "") if isinstance(node, ast.ImportFrom) else ""
        if mod.startswith("repro_torch.kernels") and \
                not mod.split(".")[-1].startswith("_"):
            out.update(a.asname or a.name for a in node.names)
    return out


def lint_source(src: str, path: str = "<string>") -> list[Finding]:
    """Lint one python source string; findings sorted by line."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:  # an unparseable file is itself a finding
        return [Finding(path, e.lineno or 0, 0, "REPRO000",
                        f"syntax error: {e.msg}")]
    scopes = _scan(tree, _suffix(path))
    linter = _Linter(path, src.splitlines(), scopes,
                     "kernels" in pathlib.PurePath(path).parts,
                     _kernel_imports(tree))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            linter.run(node, hot=False)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    linter.run(sub, hot=False)
    _check_env_clobber(tree, linter)
    linter.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return linter.findings


def lint_paths(paths, *, rules: set[str] | None = None) -> list[Finding]:
    """Lint files and directory trees (``*.py``)."""
    out: list[Finding] = []
    for p in paths:
        p = pathlib.Path(p)
        for f in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            found = lint_source(f.read_text(encoding="utf-8"), str(f))
            out.extend(x for x in found if not rules or x.rule in rules)
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis lint",
        description="the port's hot-path linter (REPRO001-004, 006, 007)")
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--rules", help="comma-separated rule ids to enable")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in RULES.items():
            print(f"{rid}  {desc}")
        return 0
    if not args.paths:
        ap.error("paths required (or --list-rules)")
    findings = lint_paths(args.paths, rules=set(args.rules.split(","))
                          if args.rules else None)
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
