"""graftlint dataflow: the interprocedural, field-sensitive layer.

Counterpart of ``deeplearning4j_tpu/analysis/dataflow.py``. The engine
(:mod:`analysis.engine`) classifies whole functions (traced / hot /
device-source). The distributed-correctness rules need to reason about
*values*: which names hold a donating step, which buffers a step makes
stale, which strings name durable store paths. This module adds that layer
on top of the :class:`engine.Index`: still pure AST, nothing here imports
torch or executes target code.

Facts computed, each threaded across the intra-package call graph and
tracked field-sensitively (``self.<attr>`` / ``obj.<attr>`` keys, per
class of the defining module):

- **donating callables** (JAX dialect: :attr:`Dataflow.local_donations`,
  :attr:`Dataflow.class_attr_donations`, :attr:`Dataflow.global_donations`,
  :attr:`Dataflow.factory_returns`): ``jax.jit(f, donate_argnums=...)``,
  ``StepProgram(...)`` (whose default donates the ``(params, opt, state)``
  carry), factories returning either, and the names/attributes they are
  bound to.
- **donating params** (:attr:`Dataflow.param_donations`): calling function
  ``g`` donates the buffer passed at position *k* because ``g``'s body
  dispatches it into a donating program.
- **in-place steps** (torch dialect: :attr:`Dataflow.step_params`): the
  port updates params, updater state and layer state in place where the
  JAX step donates them (``nn/model.py``), so its "donating callables"
  are the step methods of :data:`STEP_METHODS`: a call ``m.fit_batch(...)``
  rewrites the leaves under ``m.params`` / ``m.state`` / ``m.opt_state``.
  Function ``g`` steps its param *k* when its body steps that param.
- **durable params** (:attr:`Dataflow.durable_params`): positions through
  which checkpoint/bundle/store-marker paths flow, so raw writes inside
  helpers are judged by what their callers pass.

Statement-level def-use runs per function via :func:`ordered_statements`,
deliberately optimistic about control flow: a kill on any path counts —
the baseline absorbs what that misses, and any NEW finding fails the lint.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.engine import (
    FunctionInfo,
    Index,
    dotted_name,
    own_nodes,
)

__all__ = [
    "DURABLE_PATH_MARKERS",
    "LEAF_ATTRS",
    "STEP_METHODS",
    "Dataflow",
    "DispatchSite",
    "Donation",
    "Key",
    "key_of",
    "literal_argnums",
    "ordered_statements",
    "render_key",
    "string_constants",
]

# A tracked value: a local name ("local", name) or a one-level attribute
# access ("attr", base, attr) — field sensitivity for self.params,
# model.opt_state, and friends.
Key = Tuple[str, ...]

# Path fragments that mark a string as naming a durable artifact: FileStore
# blobs, checkpoints/bundles, the tune DB, exported weights. Writes reaching
# these must go through the CRC-framed atomic helpers (docs/ROBUSTNESS.md).
DURABLE_PATH_MARKERS = (
    "checkpoint", "ckpt", "bundle", "manifest", "lease", "blob",
    "aotbundle", "tune_db", "tunedb", "snapshot", "params_", "weights_",
    ".npz",
)

# Modules whose functions are protocol-safe sinks for durable names: they
# frame/CRC payloads end-to-end themselves (the netstore client speaks the
# same DLES framing as FileStore), so a durable key flowing into them is the
# protocol being honored, not bypassed. Durable-param taint stops here.
PROTOCOL_SAFE_SINK_MODULES = ("netstore",)

# torch dialect: the methods that run one in-place training step (or a loop
# of them) on their receiver, and the receiver attributes whose leaves such
# a step rewrites in place
STEP_METHODS = frozenset({
    "fit", "fit_batch", "_fit_batch", "_step", "_tbptt_chunk", "_fit_tbptt",
    "_apply_step", "_update_params",
})
LEAF_ATTRS = frozenset({"params", "state", "opt_state"})
# calls that keep sharing the storage of their argument (an alias, not a copy)
_ALIASING_CALLS = frozenset({"detach", "view", "view_as", "tree_leaves",
                             "list", "tuple"})


def key_of(expr: ast.AST) -> Optional[Key]:
    """The tracking key of an expression, or None for anything more complex
    than ``name`` / ``base.attr`` (subscripts, calls, nested attributes)."""
    if isinstance(expr, ast.Name):
        return ("local", expr.id)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return ("attr", expr.value.id, expr.attr)
    return None


def render_key(key: Key) -> str:
    return key[1] if key[0] == "local" else f"{key[1]}.{key[2]}"


def literal_argnums(expr: ast.AST) -> Optional[Tuple[int, ...]]:
    """Literal donate_argnums spec: int or tuple/list of ints; None if the
    spec is computed (we then refuse to guess rather than misreport)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return (expr.value,)
    if isinstance(expr, (ast.Tuple, ast.List)):
        vals = []
        for e in expr.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, int)):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


def string_constants(node: ast.AST) -> List[str]:
    """Every string literal in a subtree (f-string fragments included)."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
    return out


def ordered_statements(fi: FunctionInfo) -> List[ast.stmt]:
    """The function's own statements in source order (nested def/class
    bodies excluded, compound-statement children flattened in)."""
    return [n for n in own_nodes(fi.node) if isinstance(n, ast.stmt)]


@dataclass(frozen=True)
class Donation:
    """A callable that donates the buffers at ``positions`` of its call."""

    positions: Tuple[int, ...]
    desc: str       # human-readable construction site
    line: int       # construction line (in desc's module)

    def shifted(self, by: int) -> Optional["Donation"]:
        pos = tuple(p - by for p in self.positions if p - by >= 0)
        return Donation(pos, self.desc, self.line) if pos else None


@dataclass
class DispatchSite:
    """One donating call: ``call`` donates ``donated`` (position, key,
    arg-expression) under ``donation``."""

    stmt: ast.stmt
    call: ast.Call
    donation: Donation
    donated: List[Tuple[int, Optional[Key], ast.AST]]


# Simple statements whose subtree contains no nested statements — the only
# places dispatch calls are harvested, so compound statements (visited later
# through their flattened children) are never double-counted.
_SIMPLE_STMTS = (ast.Expr, ast.Assign, ast.AnnAssign, ast.AugAssign,
                 ast.Return)

# .dispatch() and __call__ both run the donating executable (StepProgram
# contract); .warm()/.lower() take abstract values and donate nothing.
_DISPATCH_ATTRS = {"dispatch"}

_STEP_PROGRAM_DEFAULT = (0, 1, 2)   # StepProgram's donate_argnums default


def _positional_params(fi: FunctionInfo) -> List[str]:
    a = getattr(fi.node, "args", None)   # Module pseudo-functions have none
    if a is None:
        return []
    return [p.arg for p in list(a.posonlyargs) + list(a.args)]


class Dataflow:
    """Interprocedural value facts over an :class:`engine.Index`."""

    def __init__(self, index: Index):
        self.index = index
        # ("module.dotted", class) -> attr -> Donation
        self.class_attr_donations: Dict[Tuple[str, str], Dict[str, Donation]] = {}
        # ("module.dotted", name) -> Donation (module-level bindings)
        self.global_donations: Dict[Tuple[str, str], Donation] = {}
        # function qualname -> Donation of its return value (factories)
        self.factory_returns: Dict[str, Donation] = {}
        # function qualname -> {positional param index -> Donation}
        self.param_donations: Dict[str, Dict[int, Donation]] = {}
        # function qualname -> positional param indices carrying durable paths
        self.durable_params: Dict[str, Set[int]] = {}
        # torch: function qualname -> positional param indices it steps
        self.step_params: Dict[str, Set[int]] = {}
        self._callees: Dict[int, List[str]] = {}
        self._local_cache: Dict[str, Dict[Key, Donation]] = {}
        if index.dialect.name == "jax":
            self._build_donations()
            self._build_param_donations()
        else:
            self._build_step_params()
        self._build_durable_params()

    # -- donating-callable discovery ----------------------------------------

    def donation_of_expr(self, fi: FunctionInfo,
                         expr: ast.AST) -> Optional[Donation]:
        """Does evaluating ``expr`` yield a donating callable?"""
        sm = fi.module
        if isinstance(expr, ast.Call):
            kw = {k.arg: k.value for k in expr.keywords if k.arg}
            if self.index.is_jit_call(expr, sm):
                if "donate_argnums" not in kw:
                    return None
                pos = literal_argnums(kw["donate_argnums"])
                if not pos:
                    return None
                return Donation(pos, f"jax.jit(donate_argnums={pos})",
                                expr.lineno)
            d = dotted_name(expr.func, sm)
            if d and (d == "StepProgram" or d.endswith(".StepProgram")):
                if "donate_argnums" in kw:
                    pos = literal_argnums(kw["donate_argnums"])
                    if not pos:
                        return None
                else:
                    pos = _STEP_PROGRAM_DEFAULT
                return Donation(tuple(pos),
                                f"StepProgram(donate_argnums={tuple(pos)})",
                                expr.lineno)
            # factory call: make_step() where make_step returns a donating
            # program
            for callee in self.index.resolve_call(fi, expr.func):
                don = self.factory_returns.get(callee)
                if don:
                    return don
            return None
        if isinstance(expr, ast.Name):
            return self.global_donations.get((sm.dotted, expr.id))
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base in ("self", "cls"):
                if fi.class_name:
                    hit = self.class_attr_donations.get(
                        (sm.dotted, fi.class_name), {}).get(expr.attr)
                    if hit:
                        return hit
                for (mod, _cls), attrs in self.class_attr_donations.items():
                    if mod == sm.dotted and expr.attr in attrs:
                        return attrs[expr.attr]
            return None
        return None

    def _build_donations(self):
        # fixpoint: constructions -> bindings (attrs/globals) -> factories ->
        # constructions through factory calls
        for _ in range(4):
            changed = False
            for q, fi in self.index.functions.items():
                sm = fi.module
                for node in own_nodes(fi.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        don = self.donation_of_expr(fi, node.value)
                        if don and self.factory_returns.get(q) != don:
                            self.factory_returns[q] = don
                            changed = True
                    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                        value = node.value
                        if value is None:
                            continue
                        don = self.donation_of_expr(fi, value)
                        if not don:
                            continue
                        targets = (node.targets if isinstance(node, ast.Assign)
                                   else [node.target])
                        for t in targets:
                            k = key_of(t)
                            if k is None:
                                continue
                            if k[0] == "attr" and k[1] in ("self", "cls") \
                                    and fi.class_name:
                                table = self.class_attr_donations.setdefault(
                                    (sm.dotted, fi.class_name), {})
                                if table.get(k[2]) != don:
                                    table[k[2]] = don
                                    changed = True
                            elif k[0] == "local" and not fi.scope:
                                gk = (sm.dotted, k[1])
                                if self.global_donations.get(gk) != don:
                                    self.global_donations[gk] = don
                                    changed = True
            if not changed:
                break
        self._local_cache.clear()

    def local_donations(self, fi: FunctionInfo) -> Dict[Key, Donation]:
        """Names/attrs bound to donating callables within ``fi``'s body
        (flow-insensitive: one pre-pass, later dispatch lookups hit it)."""
        cached = self._local_cache.get(fi.qualname)
        if cached is not None:
            return cached
        env: Dict[Key, Donation] = {}
        for node in own_nodes(fi.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.value is not None:
                don = self.donation_of_expr(fi, node.value)
                if not don:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    k = key_of(t)
                    if k:
                        env[k] = don
        self._local_cache[fi.qualname] = env
        return env

    # -- dispatch-site detection ---------------------------------------------

    def _callee_donation(self, fi: FunctionInfo,
                         call: ast.Call) -> Optional[Donation]:
        """Donation of a call through a donating value: ``prog(args)``,
        ``prog.dispatch(args)``, ``self._step.dispatch(args)``,
        ``jax.jit(f, donate_argnums=...)(args)``."""
        target = call.func
        if isinstance(target, ast.Attribute) and target.attr in _DISPATCH_ATTRS:
            target = target.value
        don = self.donation_of_expr(fi, target)
        if don:
            return don
        k = key_of(target)
        if k:
            don = self.local_donations(fi).get(k)
            if don:
                return don
        return None

    def _summary_donation(self, fi: FunctionInfo,
                          call: ast.Call) -> Optional[Donation]:
        """Donation through an interprocedural summary: calling ``g(x, y)``
        where ``g`` donates its param k means arg k dies here."""
        best: Optional[Donation] = None
        bound = (isinstance(call.func, ast.Attribute)
                 and isinstance(call.func.value, ast.Name)
                 and call.func.value.id in ("self", "cls"))
        for callee in self.index.resolve_call(fi, call.func):
            summary = self.param_donations.get(callee)
            if not summary:
                continue
            don = Donation(tuple(sorted(summary)),
                           f"call into {callee.split('::')[-1]} "
                           f"(donates params {tuple(sorted(summary))})",
                           call.lineno)
            if bound:
                don = don.shifted(1)   # self is param 0, not a call arg
            if don:
                best = don
                break
        return best

    def dispatch_sites(self, fi: FunctionInfo) -> List[DispatchSite]:
        """Every donating call in ``fi``, with the donated arg keys."""
        sites: List[DispatchSite] = []
        for stmt in ordered_statements(fi):
            if not isinstance(stmt, _SIMPLE_STMTS):
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                don = self._callee_donation(fi, node)
                if don is None:
                    don = self._summary_donation(fi, node)
                if don is None:
                    continue
                if any(isinstance(a, ast.Starred) for a in node.args):
                    continue   # *args dispatch: positions unknowable
                donated = []
                for pos in don.positions:
                    if pos < len(node.args):
                        arg = node.args[pos]
                        donated.append((pos, key_of(arg), arg))
                if donated:
                    sites.append(DispatchSite(stmt, node, don, donated))
        return sites

    # -- interprocedural summaries --------------------------------------------

    def _build_param_donations(self):
        """Fixpoint: a function donates its positional param k if its body
        passes that param (by name) at a donated position of a donating
        dispatch — including dispatches recognized through summaries found
        in earlier iterations."""
        for _ in range(4):
            changed = False
            for q, fi in self.index.functions.items():
                if isinstance(fi.node, ast.Module):
                    continue
                pos_params = _positional_params(fi)
                if not pos_params:
                    continue
                for site in self.dispatch_sites(fi):
                    for _pos, k, _arg in site.donated:
                        if not k or k[0] != "local" or k[1] not in pos_params:
                            continue
                        i = pos_params.index(k[1])
                        table = self.param_donations.setdefault(q, {})
                        if i not in table:
                            table[i] = site.donation
                            changed = True
            if not changed:
                break

    def _build_durable_params(self):
        """Fixpoint: param k of a callee is durable-tainted if any caller
        passes an expression carrying a durable path marker (literally or
        through its own durable names/params)."""
        for _ in range(4):
            changed = False
            for q, fi in self.index.functions.items():
                durable_names = self.durable_names(fi)
                for node in own_nodes(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    callees = self.index.resolve_call(fi, node.func)
                    if not callees:
                        continue
                    bound = (isinstance(node.func, ast.Attribute)
                             and isinstance(node.func.value, ast.Name)
                             and node.func.value.id in ("self", "cls"))
                    for ai, arg in enumerate(node.args):
                        if isinstance(arg, ast.Starred):
                            continue
                        if not self.expr_durable(fi, arg, durable_names):
                            continue
                        for callee in callees:
                            mod = callee.split("::", 1)[0].rsplit(".", 1)[-1]
                            if mod in PROTOCOL_SAFE_SINK_MODULES:
                                continue
                            cfi = self.index.functions.get(callee)
                            if cfi is None or isinstance(cfi.node, ast.Module):
                                continue
                            pp = _positional_params(cfi)
                            pi = ai + (1 if bound else 0)
                            if pi >= len(pp):
                                continue
                            slots = self.durable_params.setdefault(callee, set())
                            if pi not in slots:
                                slots.add(pi)
                                changed = True
            if not changed:
                break

    # -- durable-path taint ----------------------------------------------------

    @staticmethod
    def _marks_durable(text: str) -> bool:
        low = text.lower()
        return any(m in low for m in DURABLE_PATH_MARKERS)

    def durable_params_of(self, fi: FunctionInfo) -> Set[str]:
        slots = self.durable_params.get(fi.qualname, set())
        pp = _positional_params(fi)
        return {pp[i] for i in slots if i < len(pp)}

    def durable_names(self, fi: FunctionInfo) -> Set[str]:
        """Local names through which a durable path flows: seeded by marker
        string literals and durable params, propagated through assignments
        (two passes reach a fixpoint for straight-line join chains)."""
        names: Set[str] = set(self.durable_params_of(fi))
        nodes = own_nodes(fi.node)

        def tainted(expr: ast.AST) -> bool:
            return self.expr_durable(fi, expr, names)

        for _ in range(2):
            before = len(names)
            for node in nodes:
                if isinstance(node, ast.Assign) and tainted(node.value):
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                names.add(n.id)
                elif isinstance(node, ast.AnnAssign) and node.value is not None \
                        and tainted(node.value):
                    if isinstance(node.target, ast.Name):
                        names.add(node.target.id)
            if len(names) == before:
                break
        return names

    def expr_durable(self, fi: FunctionInfo, expr: ast.AST,
                     durable_names: Set[str]) -> bool:
        """Does ``expr`` plausibly evaluate to a durable path?"""
        for n in ast.walk(expr):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and self._marks_durable(n.value):
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in durable_names:
                return True
        return False

    def replace_sanctioned(self, fi: FunctionInfo) -> Set[str]:
        """Names that feed ``os.replace``/``os.rename``/``os.link`` as the
        SOURCE arg in this function — the tmp half of the
        write-tmp-then-rename (or tmp-then-link, for exclusive create)
        discipline. Writes targeting these are the sanctioned spelling,
        not a finding."""
        out: Set[str] = set()
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Call) \
                    and dotted_name(node.func, fi.module) in (
                        "os.replace", "os.rename", "os.link") and node.args:
                for n in ast.walk(node.args[0]):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        return out

    # -- torch: in-place steps -------------------------------------------------

    def step_receivers(self, fi: FunctionInfo, call: ast.Call) -> List[str]:
        """Names whose leaves ``call`` rewrites in place: the receiver of a
        step method (``m.fit_batch(...)``) and the args at positions the
        callee steps (``train(m, data)`` where ``train`` steps its param 0)."""
        out: List[str] = []
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in STEP_METHODS \
                and isinstance(f.value, ast.Name):
            out.append(f.value.id)
        if not self.step_params:
            return out
        bound = (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                 and f.value.id in ("self", "cls"))
        callees = self._callees.get(id(call))
        if callees is None:
            callees = self._callees[id(call)] = self.index.resolve_call(fi, f)
        for callee in callees:
            for i in self.step_params.get(callee, ()):
                ai = i - (1 if bound else 0)
                if 0 <= ai < len(call.args) and isinstance(call.args[ai], ast.Name):
                    out.append(call.args[ai].id)
        return out

    def _build_step_params(self):
        """Fixpoint: a function steps its positional param k if its body
        calls a step method on it, or passes it where a callee steps."""
        for _ in range(4):
            changed = False
            for q, fi in self.index.functions.items():
                pp = _positional_params(fi)
                if not pp:
                    continue
                for node in own_nodes(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    for name in self.step_receivers(fi, node):
                        if name in pp:
                            slots = self.step_params.setdefault(q, set())
                            i = pp.index(name)
                            if i not in slots:
                                slots.add(i)
                                changed = True
            if not changed:
                break


def leaf_alias_base(value: ast.AST) -> Optional[str]:
    """The receiver name whose step-updated leaves ``value`` aliases:
    ``m.params``, ``m.params[0]["W"]``, ``m.state[...].detach()``,
    ``tree_leaves(m.opt_state)`` all alias ``m``'s leaves; anything that
    copies (``.clone()``, arithmetic, ``.cpu()``) does not."""
    node = value
    while True:
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _ALIASING_CALLS \
                    and not node.args:
                node = f.value
                continue
            if isinstance(f, ast.Name) and f.id in _ALIASING_CALLS \
                    and len(node.args) == 1:
                node = node.args[0]
                continue
            return None
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        break
    if isinstance(node, ast.Attribute) and node.attr in LEAF_ATTRS \
            and isinstance(node.value, ast.Name):
        return node.value.id
    return None
