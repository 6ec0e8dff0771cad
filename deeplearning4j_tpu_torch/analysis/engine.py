"""graftlint engine: AST module index, call graph, traced and hot sets.

Counterpart of ``deeplearning4j_tpu/analysis/engine.py``. Pure static
analysis: nothing here imports torch or executes target code. The engine
parses every module of a target package, builds an approximate
intra-package call graph, and classifies functions into the two sets the
rules care about. What those sets mean depends on the **dialect**
(:class:`Dialect`), a small frozen table of the call names each rule looks
for:

- ``jax`` holds the reference's own tables (``jax.jit`` and friends), so
  this engine can be held against the JAX package's on its own inputs;
- ``torch`` (the default) is the port's. PyTorch runs eagerly, so:

  - **traced** is the bodies PyTorch may run twice and expects to be pure:
    ``forward``/``backward`` of every ``torch.autograd.Function`` subclass,
    every function handed to ``torch.utils.checkpoint.checkpoint`` (remat
    reruns it), and everything these reach;
  - **hot** is every function from which a dispatch site is reachable: an
    ``AotFunction`` site (``nn/aot.py`` ``AotFunction``, ``wrap``,
    ``site``, ``grid_site``) or a function that loads a kernel library
    through ``ops/_build.py`` (every kernel wrapper does, per launch).

On top of the function classification sits an interprocedural,
field-sensitive value layer (:mod:`analysis.dataflow`, reached lazily
through :attr:`Index.dataflow`): def-use chains threaded across this call
graph with ``self.<attr>`` tracked per class. The distributed-correctness
rules (use-after-donate, collective-consistency, durable-store-protocol,
:mod:`analysis.rules_distributed`) run on it.

Resolution is deliberately approximate (bare names in module scope,
``self.``/``cls.`` within same-module classes, ``module.attr`` through
package imports); the baseline and inline suppressions absorb the
imprecision, and any NEW finding fails the lint.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

__all__ = [
    "DIALECTS",
    "Dialect",
    "Finding",
    "FunctionInfo",
    "Index",
    "JAX",
    "SourceModule",
    "TORCH",
    "dotted_name",
    "own_nodes",
]

# Mutable-container constructors for module-level shared-state detection.
MUTABLE_CONSTRUCTORS = {
    "list",
    "dict",
    "set",
    "bytearray",
    "collections.defaultdict",
    "collections.deque",
    "collections.OrderedDict",
    "collections.Counter",
}
MUTATOR_METHODS = {
    "append",
    "appendleft",
    "add",
    "clear",
    "discard",
    "extend",
    "insert",
    "pop",
    "popleft",
    "popitem",
    "remove",
    "setdefault",
    "sort",
    "reverse",
    "update",
}

SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Dialect:
    """The call names one flavour of the framework dispatches, traces and
    syncs through. ``suffix_match`` lets a table entry ``a.b`` match any
    dotted name ending in ``.a.b`` (and a bare name defined in a module
    ``...a`` as ``a.b``): the port's names are matched by their tail, so
    a fixture package that mirrors its layout is read the same way. The
    JAX dialect matches exactly, as the reference does."""

    name: str
    suffix_match: bool
    # calls that build a dispatch (a jitted callable / an AotFunction site)
    # whose first argument, where the call takes one, is traced (jax) or
    # dispatched (torch)
    jit_callables: FrozenSet[str]
    # wrappers whose first argument is traced too: jit(value_and_grad(f))
    tracing_wrappers: FrozenSet[str]
    # classes whose methods below are traced roots (torch.autograd.Function)
    traced_bases: FrozenSet[str] = frozenset()
    traced_methods: FrozenSet[str] = frozenset()
    # calls that rerun their first argument (remat): traced roots
    remat_calls: FrozenSet[str] = frozenset()
    # calls that load a kernel library: a function calling one is a dispatch
    # site (every kernel wrapper loads through the cache per launch)
    kernel_loaders: FrozenSet[str] = frozenset()
    # method names that run a dispatch site whatever their receiver (the
    # receiver is rarely resolvable: ``self.model.output(x)``); a call of
    # one makes its caller a dispatch site and its result a device value
    dispatch_methods: FrozenSet[str] = frozenset()
    # the builders among ``jit_callables`` that make a FRESH wrapper (the
    # others return the owner's existing site): retrace-hazard's loop check
    fresh_callables: FrozenSet[str] = frozenset()
    # calls whose result lives on the device even without a dispatch
    device_put: FrozenSet[str] = frozenset()
    # dotted prefixes whose calls yield device values
    device_prefixes: Tuple[str, ...] = ()
    # the static-argument keywords of a jit call (retrace-hazard)
    static_keywords: FrozenSet[str] = frozenset()

    def matches(self, d: Optional[str], names: Iterable[str],
                sm: Optional["SourceModule"] = None) -> bool:
        if not d:
            return False
        if d in names:
            return True
        if not self.suffix_match:
            return False
        quals = [d] if "." in d or sm is None else [d, f"{sm.dotted}.{d}"]
        return any(q.endswith("." + n) for q in quals for n in names)


JAX = Dialect(
    name="jax",
    suffix_match=False,
    jit_callables=frozenset({
        "jax.jit", "jax.pjit", "jax.experimental.pjit.pjit", "pjit"}),
    tracing_wrappers=frozenset({
        "jax.grad", "jax.value_and_grad", "jax.vmap", "jax.pmap",
        "jax.checkpoint", "jax.remat", "functools.partial"}),
    fresh_callables=frozenset({
        "jax.jit", "jax.pjit", "jax.experimental.pjit.pjit", "pjit"}),
    device_put=frozenset({"jax.device_put"}),
    device_prefixes=("jax.",),
    static_keywords=frozenset({"static_argnums", "static_argnames"}),
)

TORCH = Dialect(
    name="torch",
    suffix_match=True,
    jit_callables=frozenset({
        "AotFunction", "aot.AotFunction", "aot.wrap", "aot.site",
        "aot.grid_site"}),
    tracing_wrappers=frozenset({"functools.partial"}),
    traced_bases=frozenset({"torch.autograd.Function", "autograd.Function"}),
    traced_methods=frozenset({"forward", "backward", "setup_context",
                              "jvp", "vjp"}),
    remat_calls=frozenset({"torch.utils.checkpoint.checkpoint",
                           "torch.utils.checkpoint.checkpoint_sequential"}),
    kernel_loaders=frozenset({"ops._build.load"}),
    # the models' and programs' entry points onto their AotFunction sites
    dispatch_methods=frozenset({
        "output", "rnn_time_step", "fit", "fit_batch", "_fit_batch",
        "_get_output_fn", "_get_step_fn", "_get_tbptt_fn", "dispatch"}),
    fresh_callables=frozenset({"AotFunction", "aot.AotFunction", "aot.wrap"}),
    device_prefixes=("torch.",),
)

DIALECTS = {"jax": JAX, "torch": TORCH}


@dataclass(frozen=True)
class Finding:
    """One rule violation. ``fingerprint`` is line-number free (path + rule
    + enclosing function + normalized source text) so the baseline survives
    unrelated edits that shift line numbers."""

    rule: str
    path: str          # posix path relative to the lint root's parent
    line: int
    func: str          # enclosing function qualname ("<module>" at top level)
    message: str
    norm: str = ""     # normalized source line text (fingerprint component)

    @property
    def fingerprint(self) -> str:
        return f"{self.path}::{self.rule}::{self.func}::{self.norm}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.func}: {self.message}"


def own_nodes(fn_node: ast.AST) -> List[ast.AST]:
    """All AST nodes belonging to a function (or module) body EXCLUDING
    nested function/class bodies — those are separate FunctionInfos.
    Lambdas stay included: they execute in the enclosing scope. The list is
    computed once per node and kept on it (callers must not mutate it)."""
    cached = getattr(fn_node, "_graftlint_own", None)
    if cached is not None:
        return cached
    out: List[ast.AST] = []

    def rec(n: ast.AST):
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            out.append(c)
            rec(c)

    body = getattr(fn_node, "body", [])
    for stmt in body if isinstance(body, list) else []:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        out.append(stmt)
        rec(stmt)
    fn_node._graftlint_own = out
    return out


@dataclass
class FunctionInfo:
    """One function (or the module top-level pseudo-function)."""

    qualname: str                       # "nn.model::MultiLayerNetwork.fit"
    module: "SourceModule"
    node: ast.AST                       # FunctionDef / AsyncFunctionDef / Module
    scope: Tuple[str, ...]              # ("MultiLayerNetwork", "fit")
    class_name: Optional[str] = None    # innermost enclosing class
    params: Set[str] = field(default_factory=set)
    calls: Set[str] = field(default_factory=set)   # resolved callee qualnames

    @property
    def local_name(self) -> str:
        return self.scope[-1] if self.scope else "<module>"

    def local_qual(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"


class SourceModule:
    """Parsed module + symbol tables."""

    def __init__(self, dotted: str, path: str, relpath: str, source: str):
        self.dotted = dotted            # full dotted name incl. package prefix
        self.path = path
        self.relpath = relpath          # posix, relative to lint root's parent
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.is_package = os.path.basename(path) == "__init__.py"
        self.imports: Dict[str, str] = {}       # local alias -> dotted target
        self.functions: Dict[str, FunctionInfo] = {}   # qualname -> info
        self.classes: Dict[str, Dict[str, str]] = {}   # class -> method -> qualname
        self.class_bases: Dict[str, List[ast.expr]] = {}   # class -> base exprs
        self.mutable_globals: Dict[str, int] = {}      # name -> lineno
        self.global_names: Set[str] = set()            # all top-level bindings
        self.imports_threading = False

    # -- suppression -------------------------------------------------------
    def suppressed(self, line: int, rule: str) -> bool:
        """``# graftlint: disable=<rule>[,<rule>...]`` on the flagged line or
        the line directly above (``all`` disables every rule)."""
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = SUPPRESS_RE.search(self.lines[ln - 1])
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    if rule in rules or "all" in rules:
                        return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return " ".join(self.lines[line - 1].split())
        return ""


def dotted_name(expr: ast.AST, sm: SourceModule) -> Optional[str]:
    """Best-effort dotted path of a Name/Attribute chain, resolving the
    leading name through the module's imports (``np.pad`` -> ``numpy.pad``).
    Bare un-imported names resolve to themselves."""
    if isinstance(expr, ast.Name):
        return sm.imports.get(expr.id, expr.id)
    if isinstance(expr, ast.Attribute):
        base = dotted_name(expr.value, sm)
        if base:
            return base + "." + expr.attr
    return None


class Index:
    """Package-wide analysis index.

    ``root`` is the directory of the package to lint (or a single ``.py``
    file). All paths in findings are relative to the root's parent, so
    ``deeplearning4j_tpu_torch/nn/model.py`` reads naturally from the repo
    root. ``dialect`` is ``"torch"`` (default) or ``"jax"``.
    """

    def __init__(self, root: str, dialect: str = "torch"):
        if dialect not in DIALECTS:
            raise ValueError(f"unknown graftlint dialect {dialect!r} "
                             f"(known: {', '.join(sorted(DIALECTS))})")
        self.dialect: Dialect = DIALECTS[dialect]
        root = os.path.abspath(root)
        if os.path.isfile(root):
            base = os.path.dirname(root)
            files = [root]
        else:
            base = root
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(".") and d != "__pycache__")
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        self.root = base
        self.pkg = os.path.basename(base)
        self.modules: Dict[str, SourceModule] = {}
        self.errors: List[Finding] = []
        for path in files:
            rel = os.path.relpath(path, base).replace(os.sep, "/")
            parts = rel[:-3].split("/")          # strip .py
            if parts[-1] == "__init__":
                parts = parts[:-1]
            dotted = ".".join([self.pkg] + parts) if parts else self.pkg
            relout = f"{self.pkg}/{rel}"
            try:
                with open(path, encoding="utf-8") as fh:
                    src = fh.read()
                sm = SourceModule(dotted, path, relout, src)
            except (SyntaxError, UnicodeDecodeError) as e:
                self.errors.append(Finding(
                    "parse-error", relout, getattr(e, "lineno", 0) or 0,
                    "<module>", f"cannot parse: {e}"))
                continue
            self.modules[dotted] = sm
        self.functions: Dict[str, FunctionInfo] = {}
        for sm in self.modules.values():
            self._scan_module(sm)
        self._build_call_graph()
        self._find_jit()
        self._compute_sets()
        self._dataflow = None

    @property
    def dataflow(self):
        """The interprocedural field-sensitive value layer
        (:class:`analysis.dataflow.Dataflow`), built on first use — the
        classification rules never pay for it."""
        if self._dataflow is None:
            from deeplearning4j_tpu_torch.analysis.dataflow import Dataflow
            self._dataflow = Dataflow(self)
        return self._dataflow

    def is_jit_call(self, call: ast.AST, sm: SourceModule) -> bool:
        """Does ``call`` build a dispatch (a jit wrapper / an AotFunction)?"""
        return isinstance(call, ast.Call) and self.dialect.matches(
            dotted_name(call.func, sm), self.dialect.jit_callables, sm)

    def is_fresh_jit_call(self, call: ast.AST, sm: SourceModule) -> bool:
        """A call that builds a new dispatch wrapper (not a lookup)."""
        return isinstance(call, ast.Call) and self.dialect.matches(
            dotted_name(call.func, sm), self.dialect.fresh_callables, sm)

    def is_dispatch_method_call(self, call: ast.AST) -> bool:
        return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr in self.dialect.dispatch_methods)

    # -- per-module scan ---------------------------------------------------
    def _scan_module(self, sm: SourceModule):
        for node in ast.walk(sm.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    sm.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
                    if a.asname:
                        sm.imports[a.asname] = a.name
                    if a.name.split(".")[0] == "threading":
                        sm.imports_threading = True
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(sm, node)
                for a in node.names:
                    if a.name == "*":
                        continue
                    target = f"{base}.{a.name}" if base else a.name
                    sm.imports[a.asname or a.name] = target
                if base == "threading":
                    sm.imports_threading = True

        # module top-level pseudo-function
        mod_fi = FunctionInfo(f"{sm.dotted}::<module>", sm, sm.tree, ())
        sm.functions[mod_fi.qualname] = mod_fi
        self.functions[mod_fi.qualname] = mod_fi

        class_stack: List[str] = []

        def register(node: ast.AST, scope: Tuple[str, ...]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    sub = scope + (child.name,)
                    fi = FunctionInfo(
                        f"{sm.dotted}::{'.'.join(sub)}", sm, child, sub,
                        class_name=class_stack[-1] if class_stack else None,
                        params={a.arg for a in (
                            child.args.posonlyargs + child.args.args
                            + child.args.kwonlyargs)}
                        | ({child.args.vararg.arg} if child.args.vararg else set())
                        | ({child.args.kwarg.arg} if child.args.kwarg else set()),
                    )
                    sm.functions[fi.qualname] = fi
                    self.functions[fi.qualname] = fi
                    if class_stack and len(scope) >= 1 and scope[-1] == class_stack[-1]:
                        sm.classes.setdefault(class_stack[-1], {})[child.name] = fi.qualname
                    register(child, sub)
                elif isinstance(child, ast.ClassDef):
                    class_stack.append(child.name)
                    sm.classes.setdefault(child.name, {})
                    sm.class_bases[child.name] = list(child.bases)
                    register(child, scope + (child.name,))
                    class_stack.pop()
                else:
                    register(child, scope)

        register(sm.tree, ())

        # module-level bindings + mutable containers
        for stmt in sm.tree.body:
            targets: List[ast.expr] = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            for t in targets:
                if isinstance(t, ast.Name):
                    sm.global_names.add(t.id)
                    if self._is_mutable_container(value, sm):
                        sm.mutable_globals[t.id] = stmt.lineno
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                sm.global_names.add(stmt.name)

    def _import_base(self, sm: SourceModule, node: ast.ImportFrom) -> str:
        if node.level == 0:
            return node.module or ""
        parts = sm.dotted.split(".")
        if not sm.is_package:
            parts = parts[:-1]
        parts = parts[: len(parts) - (node.level - 1)]
        if node.module:
            parts.append(node.module)
        return ".".join(parts)

    @staticmethod
    def _is_mutable_container(value: Optional[ast.AST], sm: SourceModule) -> bool:
        if isinstance(value, (ast.List, ast.Dict, ast.Set,
                              ast.ListComp, ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            return dotted_name(value.func, sm) in MUTABLE_CONSTRUCTORS
        return False

    # -- resolution --------------------------------------------------------
    def _resolve_local(self, fi: FunctionInfo, name: str) -> Optional[str]:
        """Resolve a bare name in fi's scope chain: nested defs shadow
        module-level ones."""
        sm = fi.module
        for k in range(len(fi.scope), -1, -1):
            cand = f"{sm.dotted}::{'.'.join(fi.scope[:k] + (name,))}"
            if cand in sm.functions:
                return cand
        return None

    def _resolve_import_target(self, dotted: str) -> Optional[str]:
        """Map an imported dotted path to a function qualname in the index
        (``pkg.utils.bucketing.telemetry`` -> ``pkg.utils.bucketing::telemetry``)."""
        if dotted in self.modules:
            return None  # a module, not a function
        head, _, tail = dotted.rpartition(".")
        if head in self.modules:
            cand = f"{head}::{tail}"
            if cand in self.modules[head].functions:
                return cand
        return None

    def resolve_call(self, fi: FunctionInfo, func_expr: ast.AST) -> List[str]:
        """Resolve a call's target(s) to function qualnames (possibly empty)."""
        sm = fi.module
        if isinstance(func_expr, ast.Name):
            local = self._resolve_local(fi, func_expr.id)
            if local:
                return [local]
            target = sm.imports.get(func_expr.id)
            if target:
                hit = self._resolve_import_target(target)
                if hit:
                    return [hit]
            return []
        if isinstance(func_expr, ast.Attribute):
            base = func_expr.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                # same class first, then any same-module class (approximates
                # inheritance between classes of one module)
                if fi.class_name and func_expr.attr in sm.classes.get(fi.class_name, {}):
                    return [sm.classes[fi.class_name][func_expr.attr]]
                hits = [methods[func_expr.attr] for methods in sm.classes.values()
                        if func_expr.attr in methods]
                return hits
            d = dotted_name(func_expr, sm)
            if d:
                hit = self._resolve_import_target(d)
                if hit:
                    return [hit]
        return []

    # -- call graph --------------------------------------------------------
    def _build_call_graph(self):
        self.edges: Dict[str, Set[str]] = {q: set() for q in self.functions}
        for q, fi in self.functions.items():
            # defining a nested function wires an edge to it (closures are
            # near-always invoked or returned by their parent)
            prefix = q + "."
            for other in fi.module.functions:
                if other.startswith(prefix) and "." not in other[len(prefix):]:
                    self.edges[q].add(other)
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Call):
                    for callee in self.resolve_call(fi, node.func):
                        if callee != q:
                            self.edges[q].add(callee)
                            fi.calls.add(callee)
        self.redges: Dict[str, Set[str]] = {q: set() for q in self.functions}
        for q, outs in self.edges.items():
            for o in outs:
                self.redges.setdefault(o, set()).add(q)

    # -- dispatch discovery ------------------------------------------------
    def _find_jit(self):
        """Fixpoint over: jit factories (functions returning dispatch
        callables), jit names (attrs/globals holding them), jit sites
        (functions that construct or dispatch them), traced roots."""
        dia = self.dialect
        self.jit_factories: Set[str] = set()
        self.jit_names: Set[str] = set()
        self.jit_sites: Set[str] = set()
        self.traced_roots: Set[str] = set()
        self.jit_call_nodes: List[Tuple[FunctionInfo, ast.Call]] = []

        for fi in self.functions.values():
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Call) and self.is_jit_call(node, fi.module):
                    self.jit_call_nodes.append((fi, node))

        # decorated functions are traced roots AND their def site dispatches
        for fi in self.functions.values():
            for dec in getattr(fi.node, "decorator_list", []):
                d = (dotted_name(dec, fi.module) if not isinstance(dec, ast.Call)
                     else dotted_name(dec.func, fi.module))
                if dia.matches(d, dia.jit_callables, fi.module):
                    self.traced_roots.add(fi.qualname)
                    self.jit_sites.add(fi.qualname)
                elif isinstance(dec, ast.Call) and d == "functools.partial" and dec.args:
                    if dia.matches(dotted_name(dec.args[0], fi.module),
                                   dia.jit_callables, fi.module):
                        self.traced_roots.add(fi.qualname)
                        self.jit_sites.add(fi.qualname)

        for _ in range(4):  # small fixpoint: factory -> name -> factory chains
            changed = False
            for fi in self.functions.values():
                for node in own_nodes(fi.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        if self._produces_jit(fi, node.value):
                            if fi.qualname not in self.jit_factories:
                                self.jit_factories.add(fi.qualname)
                                changed = True
                    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                        value = node.value
                        if value is None or not self._produces_jit(fi, value):
                            continue
                        targets = (node.targets if isinstance(node, ast.Assign)
                                   else [node.target])
                        for t in targets:
                            name = self._binding_name(t, fi)
                            if name and name not in self.jit_names:
                                self.jit_names.add(name)
                                changed = True
            if not changed:
                break

        # jit sites: construct a dispatch, read a dispatch-holding name/attr,
        # call a dispatch method, or load a kernel library
        for fi in self.functions.values():
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Call) and (
                        self.is_jit_call(node, fi.module)
                        or self.is_dispatch_method_call(node)
                        or (dia.kernel_loaders and dia.matches(
                            dotted_name(node.func, fi.module),
                            dia.kernel_loaders, fi.module))):
                    self.jit_sites.add(fi.qualname)
                elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                    if node.attr in self.jit_names:
                        self.jit_sites.add(fi.qualname)
                elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                    if node.id in self.jit_names and node.id in fi.module.global_names:
                        self.jit_sites.add(fi.qualname)

        if dia.name == "jax":
            # traced roots from jit call arguments
            for fi, call in self.jit_call_nodes:
                arg = None
                if call.args:
                    arg = call.args[0]
                else:
                    for kw in call.keywords:
                        if kw.arg in ("fun", "f"):
                            arg = kw.value
                if arg is not None:
                    self.traced_roots.update(self._roots_from(fi, arg, depth=0))
            return

        # torch: autograd.Function bodies and functions remat reruns
        for sm in self.modules.values():
            for cls, bases in sm.class_bases.items():
                if not any(dia.matches(dotted_name(b, sm), dia.traced_bases, sm)
                           for b in bases):
                    continue
                for meth, q in sm.classes.get(cls, {}).items():
                    if meth in dia.traced_methods:
                        self.traced_roots.add(q)
        for fi in self.functions.values():
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Call) and node.args and dia.matches(
                        dotted_name(node.func, fi.module), dia.remat_calls,
                        fi.module):
                    self.traced_roots.update(self._roots_from(fi, node.args[0], 0))

    def _binding_name(self, target: ast.AST, fi: FunctionInfo) -> Optional[str]:
        if isinstance(target, ast.Attribute):
            return target.attr
        if isinstance(target, ast.Subscript):
            return self._binding_name(target.value, fi)
        if isinstance(target, ast.Name) and not fi.scope:  # module level
            return target.id
        return None

    def _produces_jit(self, fi: FunctionInfo, expr: ast.AST) -> bool:
        """Does evaluating ``expr`` plausibly yield a dispatch callable?"""
        if isinstance(expr, ast.Call):
            if self.is_jit_call(expr, fi.module):
                return True
            return any(c in self.jit_factories
                       for c in self.resolve_call(fi, expr.func))
        if isinstance(expr, ast.Attribute):
            return expr.attr in self.jit_names
        if isinstance(expr, ast.Name):
            return expr.id in self.jit_names and expr.id in fi.module.global_names
        return False

    def _roots_from(self, fi: FunctionInfo, expr: ast.AST, depth: int) -> Set[str]:
        """Traced functions named by a jit-call (or remat-call) argument."""
        if depth > 3:
            return set()
        out: Set[str] = set()
        if isinstance(expr, (ast.Name, ast.Attribute)):
            if isinstance(expr, ast.Name):
                hit = self._resolve_local(fi, expr.id)
                if hit:
                    out.add(hit)
            else:
                out.update(self.resolve_call(fi, expr))
        elif isinstance(expr, ast.Call):
            d = dotted_name(expr.func, fi.module)
            if d in self.dialect.tracing_wrappers and expr.args:
                out.update(self._roots_from(fi, expr.args[0], depth + 1))
            else:
                # factory call: the functions its returns name are the roots
                for callee in self.resolve_call(fi, expr.func):
                    cfi = self.functions.get(callee)
                    if cfi is None:
                        continue
                    for node in own_nodes(cfi.node):
                        if isinstance(node, ast.Return) and node.value is not None:
                            out.update(self._roots_from(cfi, node.value, depth + 1))
        return out

    # -- reachability ------------------------------------------------------
    def _reach(self, seeds: Iterable[str], edges: Dict[str, Set[str]]) -> Set[str]:
        seen = set(seeds)
        frontier = list(seen)
        while frontier:
            nxt = []
            for q in frontier:
                for o in edges.get(q, ()):
                    if o not in seen:
                        seen.add(o)
                        nxt.append(o)
            frontier = nxt
        return seen

    def _compute_sets(self):
        # traced: forward closure of traced roots
        self.traced: Set[str] = self._reach(self.traced_roots, self.edges)
        # hot: everything that can REACH a dispatch site (reverse closure)
        self.hot: Set[str] = self._reach(self.jit_sites, self.redges)
        # device sources: functions that (transitively) put values on the
        # device — their results are device values without a dispatch
        put_seeds = set()
        if self.dialect.device_put:
            for fi in self.functions.values():
                for node in own_nodes(fi.node):
                    if isinstance(node, ast.Call) and self.dialect.matches(
                            dotted_name(node.func, fi.module),
                            self.dialect.device_put, fi.module):
                        put_seeds.add(fi.qualname)
        self.device_sources: Set[str] = self._reach(put_seeds, self.redges)

    # -- convenience -------------------------------------------------------
    def make_finding(self, rule: str, fi: FunctionInfo, line: int,
                     message: str) -> Optional[Finding]:
        """Build a Finding unless suppressed inline."""
        sm = fi.module
        if sm.suppressed(line, rule):
            return None
        return Finding(rule, sm.relpath, line, fi.local_qual(), message,
                       norm=sm.line_text(line))
