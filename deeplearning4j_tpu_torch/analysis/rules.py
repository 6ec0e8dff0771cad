"""graftlint rule engine: trace-safety + distributed-correctness rules.

Counterpart of ``deeplearning4j_tpu/analysis/rules.py``: the same twelve
rule names, each in two dialects (``engine.Dialect``). In the JAX dialect
every rule is the reference's own. In the torch dialect (the port's
default) a rule keeps its hazard and reads PyTorch's names for it:

| rule              | set it runs on        | torch form                           |
|-------------------|-----------------------|--------------------------------------|
| host-sync         | hot (dispatch path)   | ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``.nonzero()``, float/int/bool or ``np.asarray``/``np.array`` of a device value, boolean-mask indexing of one, ``torch.cuda.synchronize``, ``Event``/``Stream`` ``.synchronize()`` |
| retrace-hazard    | everything            | an ``AotFunction``/``aot.wrap`` built in a loop or built and called at once (its signature table is lost, as a fresh ``jax.jit`` wrapper's cache is); a kernel library loaded outside ``ops/_build.py``'s cache; a traced body reading module state something mutates |
| jit-purity        | traced                | wall clock, Python ``random``, global ``np.random``, a torch draw without ``generator=``, module-state writes: remat's recompute or a second backward sees other values |
| numpy-on-tracer   | traced                | a numpy call on a tensor: raises on a CUDA tensor, passes on the CPU |
| lock-discipline   | threaded modules      | as the reference (the sync sub-check with the torch syncs) |
| monotonic-clock   | everything            | as the reference                     |
| cost-analysis-off-hot-path | traced + hot | the counting pass (``count_pass``, ``FlopCounterMode``, the byte-summing mode ``_bytes_mode``), trace export, fleet federation |
| tuner-off-hot-path | traced + hot         | as the reference (``tune/search.py``, ``tune/trial.py``) |
| step-wiring       | nn/ + parallel/       | an in-place update (``copy_``/``add_``/``sub_``/``mul_``/``div_``/``addcmul_``/``addcdiv_``) under ``torch.no_grad()`` outside :data:`STEP_MODULES` |
| use-after-donate  | dataflow (steps)      | a name aliasing a model's ``params``/``state``/``opt_state`` leaves, bound before an in-place step and read after it without ``.clone()`` |
| collective-consistency | dataflow (ranks) | a ``torch.distributed`` or ``parallel/comm.py`` collective under a rank-dependent branch; a group made outside ``parallel/mesh.py`` |
| durable-store-protocol | dataflow (paths) | raw ``open(..., "w")``, ``np.save``, ``torch.save``, ``zipfile.ZipFile(..., "w")`` on a durable path outside a tmp + ``os.replace`` |

What the torch forms chose where PyTorch left a choice:

- **host-sync** reads no parameter of a hot function as a device value
  (the reference's choice too): a value is a device value when it comes
  from a ``torch.*`` call, a dispatch, or a call into a hot function.
  Boolean-mask indexing is flagged when the index is a comparison of a
  device value written in place (``x[x > 0]``); a mask bound to a name
  first is not followed (narrower, no false positives on host masks).
- **retrace-hazard**'s static-argument check has no torch form (an
  ``AotFunction`` keys every plain argument by value) and stays JAX-only;
  ``aot.site`` / ``aot.grid_site`` in a loop are not flagged (they return
  the owner's existing site after the first call), and a traced body's
  read of a module global counts only when some function mutates that
  global (eager PyTorch re-reads it every run, so an unmutated one cannot
  differ between a forward and its recompute).
- **step-wiring** allows the modules whose steps update in place under a
  ``with torch.no_grad()`` of their own (:data:`STEP_MODULES`, read from
  the code: the per-layer update of ``nn/model.py`` and ``nn/graph.py``,
  the staged update of ``parallel/gpipe.py``). ``torch.no_grad()`` counts
  only as written in the function's own ``with``, so an update in a helper
  its caller wraps (the exchange's ``parallel/grads.py``) is not
  followed.
- **use-after-donate** follows aliases one assignment deep and steps
  through interprocedural summaries (a helper that steps its argument),
  like the reference's donation tracking; a read through a ``.clone()``
  is never an alias.

The last three run on the interprocedural field-sensitive dataflow layer
(``Index.dataflow``) and live in :mod:`analysis.rules_distributed`; this
module re-exports them through :data:`ALL_RULES` / :func:`run` so the CLI
and baseline treat every rule uniformly.

Each checker yields ``engine.Finding`` objects; inline
``# graftlint: disable=<rule>`` suppressions are honored by
``Index.make_finding`` (same line or the line above).
"""

from __future__ import annotations

import ast
from typing import Callable, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.engine import (
    MUTATOR_METHODS,
    Finding,
    FunctionInfo,
    Index,
    dotted_name,
    own_nodes,
)
from deeplearning4j_tpu_torch.analysis.rules_distributed import (
    DISTRIBUTED_RULES,
    run_distributed,
)

__all__ = ["ALL_RULES", "STEP_MODULES", "run"]

ALL_RULES = (
    "host-sync",
    "retrace-hazard",
    "jit-purity",
    "numpy-on-tracer",
    "lock-discipline",
    "monotonic-clock",
    "cost-analysis-off-hot-path",
    "tuner-off-hot-path",
    "step-wiring",
) + DISTRIBUTED_RULES

# numpy calls that only touch metadata — safe on tracers and device arrays
NP_METADATA_OK = {
    "shape", "ndim", "size", "dtype", "result_type", "issubdtype",
    "broadcast_shapes", "iterable", "isscalar",
}

IMPURE_CALLS = {
    "time.time": "time.time() is baked in at trace time (every later call "
                 "reuses the traced value); use a traced input instead",
    "time.time_ns": "time.time_ns() is baked in at trace time",
    "time.monotonic": "time.monotonic() is baked in at trace time",
    "datetime.datetime.now": "datetime.now() is baked in at trace time",
    "datetime.datetime.utcnow": "datetime.utcnow() is baked in at trace time",
}
# torch: a traced body runs again in remat's recompute and may run in a
# second backward; a clock read there differs between the runs
_TORCH_IMPURE = dict(
    {k: f"{k.rsplit('.', 1)[-1]}() differs between the forward and its "
        "recompute (remat, a second backward)" for k in IMPURE_CALLS},
    **{"time.perf_counter": "time.perf_counter() differs between the forward "
                            "and its recompute"})

# torch draws that take the global generator unless given ``generator=``
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.bernoulli", "torch.multinomial", "torch.normal", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
}
_TORCH_DRAW_METHODS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}

# host-sync tables: calls that always sync, methods that sync on a device
# value, methods that sync whatever their receiver
_SYNC_CALLS = {"jax": {"jax.device_get"}, "torch": {"torch.cuda.synchronize"}}
_SYNC_METHODS = {"jax": {"item"},
                 "torch": {"item", "tolist", "cpu", "numpy", "nonzero"}}
_SYNC_ANY_METHODS = {"jax": set(), "torch": {"synchronize"}}
# methods that only ever move a value to the host: flagged on any receiver
_SYNC_ANY_RECEIVER = {"jax": set(), "torch": {"cpu"}}
# methods whose result is a host value (a name bound to one holds no device
# value, whatever it was computed from)
_HOST_RESULTS = {"jax": set(), "torch": {"numpy", "tolist", "item", "cpu"}}
_NP_PULLS = ("numpy.asarray", "numpy.array", "numpy.copy")

# torch step-wiring: the modules the port's in-place steps live in
STEP_MODULES = ("nn/model.py", "nn/graph.py", "parallel/gpipe.py")
_INPLACE_UPDATES = {"copy_", "add_", "sub_", "mul_", "div_", "addcmul_",
                    "addcdiv_", "lerp_", "zero_"}


def run(index: Index, rules: Optional[Sequence[str]] = None) -> List[Finding]:
    active = set(rules) if rules else set(ALL_RULES)
    out: List[Finding] = []
    if "host-sync" in active:
        out += _rule_host_sync(index)
    if "retrace-hazard" in active:
        out += _rule_retrace_hazard(index)
    if "jit-purity" in active:
        out += _rule_jit_purity(index)
    if "numpy-on-tracer" in active:
        out += _rule_numpy_on_tracer(index)
    if "lock-discipline" in active:
        out += _rule_lock_discipline(index)
    if "monotonic-clock" in active:
        out += _rule_monotonic_clock(index)
    if "cost-analysis-off-hot-path" in active:
        out += _rule_cost_analysis_off_hot_path(index)
    if "tuner-off-hot-path" in active:
        out += _rule_tuner_off_hot_path(index)
    if "step-wiring" in active:
        out += _rule_step_wiring(index)
    if active & set(DISTRIBUTED_RULES):
        out += run_distributed(index, sorted(active & set(DISTRIBUTED_RULES)))
    # drop duplicates (one line can trip a rule through several sub-checks)
    seen: Set[tuple] = set()
    uniq = []
    for f in out:
        key = (f.rule, f.path, f.line, f.func)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# taint: which local names hold device values / tracer values
# ---------------------------------------------------------------------------


def _device_taint(
    fi: FunctionInfo, index: Index, seed_params: bool,
) -> Tuple[Set[str], Callable[[ast.AST], bool]]:
    """Names in ``fi`` that plausibly hold device/tracer values — parameters
    (for traced functions), plus anything assigned (or loop-iterated) from a
    jax/jnp call, a jitted-callable dispatch, or a call into the hot /
    device-source sets — and a predicate testing whether an expression
    involves such a value. Two linear passes over the body reach a fixpoint
    for ordinary straight-line reassignment chains."""
    tainted: Set[str] = set(fi.params) if seed_params else set()

    def call_is_source(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and (f.attr in index.jit_names
                                             or index.is_dispatch_method_call(call)):
            return True
        if (isinstance(f, ast.Name) and f.id in index.jit_names
                and f.id in fi.module.global_names):
            return True
        d = dotted_name(f, fi.module)
        if d and d.startswith(index.dialect.device_prefixes):
            return True
        return any(c in index.hot or c in index.device_sources
                   for c in index.resolve_call(fi, f))

    def expr_tainted(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                    and n.id in tainted):
                return True
            if isinstance(n, ast.Call) and call_is_source(n):
                return True
        return False

    host_results = _HOST_RESULTS[index.dialect.name]

    def host_value(expr: ast.AST) -> bool:
        # torch: ``x.cpu().numpy()`` and friends are host values already
        return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in host_results)

    nodes = own_nodes(fi.node)
    # names the function (also) binds to a host copy: read as host values
    # (optimistic about control flow, like the rest of the taint)
    host_names: Set[str] = {
        t.id for node in nodes if isinstance(node, ast.Assign)
        and host_value(node.value) for tgt in node.targets
        for t in ast.walk(tgt) if isinstance(t, ast.Name)} if host_results else set()
    tainted -= host_names

    def taint_target(t: ast.AST):
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and n.id not in host_names:
                tainted.add(n.id)

    def device_value(expr: ast.AST) -> bool:
        return not host_value(expr) and expr_tainted(expr)

    for _ in range(2):
        before = len(tainted)
        for node in nodes:
            if isinstance(node, ast.Assign) and device_value(node.value):
                for t in node.targets:
                    taint_target(t)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and expr_tainted(node.value):
                taint_target(node.target)
            elif isinstance(node, ast.AugAssign) and expr_tainted(node.value):
                taint_target(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)) and expr_tainted(node.iter):
                taint_target(node.target)
        if len(tainted) == before:
            break
    return tainted, expr_tainted


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


def _is_cpu_spec(expr: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as a ``.to(...)`` target."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    return (isinstance(expr, ast.Call) and bool(expr.args)
            and isinstance(expr.args[0], ast.Constant)
            and expr.args[0].value == "cpu")


def _sync_message(index: Index, fi: FunctionInfo, node: ast.AST,
                  tainted) -> Optional[str]:
    """Why ``node`` syncs the host with the device, or None."""
    dia = index.dialect.name
    sm = fi.module
    if isinstance(node, ast.Subscript):
        # boolean-mask indexing: its result's shape depends on the data
        sl = node.slice
        if dia == "torch" and isinstance(sl, (ast.Compare, ast.UnaryOp)) \
                and tainted(sl) and tainted(node.value):
            return ("boolean-mask indexing of a device value: the result's "
                    "shape depends on the data, so the host waits for it")
        return None
    if not isinstance(node, ast.Call):
        return None
    d = dotted_name(node.func, sm)
    if d in _SYNC_CALLS[dia]:
        return f"{d} on the dispatch path: blocks the host on the device"
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_ANY_METHODS[dia] and not node.args:
            return (f".{f.attr}() on the dispatch path: blocks the host on "
                    "the device")
        if f.attr in _SYNC_METHODS[dia] and not node.args and (
                tainted(f.value) or f.attr in _SYNC_ANY_RECEIVER[dia]):
            return (f".{f.attr}() on a device value in the dispatch path: "
                    "synchronous host round-trip per call")
        if dia == "torch" and f.attr == "to" and tainted(f.value) and any(
                _is_cpu_spec(a) for a in list(node.args)
                + [k.value for k in node.keywords if k.arg == "device"]):
            return ('.to("cpu") on a device value in the dispatch path: '
                    "copies it to the host and waits")
    if d in _NP_PULLS and node.args and any(tainted(a) for a in node.args):
        return (f"{d.replace('numpy', 'np')} on a device value in the "
                "dispatch path: pulls the array back to host")
    if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
            and node.args and tainted(node.args[0]):
        return (f"{f.id}() on a device value in the dispatch path: blocks "
                "until the device finishes")
    return None


def _rule_host_sync(index: Index) -> List[Finding]:
    out = []
    for q in sorted(index.hot):
        fi = index.functions[q]
        _, tainted = _device_taint(fi, index, seed_params=False)
        for node in own_nodes(fi.node):
            msg = _sync_message(index, fi, node, tainted)
            if msg:
                f = index.make_finding("host-sync", fi, node.lineno, msg)
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------


def _static_spec_is_literal(v: ast.AST) -> bool:
    if isinstance(v, ast.Constant):
        return isinstance(v.value, (int, str))
    if isinstance(v, (ast.Tuple, ast.List)):
        return all(isinstance(e, ast.Constant) and isinstance(e.value, (int, str))
                   for e in v.elts)
    return False


# raw shared-library loads: only ops/_build.py's cache may load a kernel
# library (one load per process, checked against its source digest)
_RAW_LIB_LOADS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
                  "torch.utils.cpp_extension.load",
                  "torch.utils.cpp_extension.load_inline"}


def _rule_retrace_hazard(index: Index) -> List[Finding]:
    out = []
    torch_dialect = index.dialect.name == "torch"

    def check_jit_call(fi: FunctionInfo, call: ast.Call, loop_depth: int):
        if loop_depth > 0:
            f = index.make_finding(
                "retrace-hazard", fi, call.lineno,
                "dispatch site built inside a loop: a fresh wrapper per "
                "iteration starts an empty signature table (a fresh jit "
                "wrapper's empty cache) every time")
            if f:
                out.append(f)
        for kw in call.keywords:
            if kw.arg in index.dialect.static_keywords \
                    and not _static_spec_is_literal(kw.value):
                f = index.make_finding(
                    "retrace-hazard", fi, call.lineno,
                    f"{kw.arg} is not a literal int/str (tuple): non-hashable "
                    "or array-valued static specs retrace per call or fail "
                    "to cache")
                if f:
                    out.append(f)

    def scan(fi: FunctionInfo, node: ast.AST, loop_depth: int):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                if index.is_fresh_jit_call(child, fi.module):
                    check_jit_call(fi, child, loop_depth)
                if isinstance(child.func, ast.Call) \
                        and index.is_fresh_jit_call(child.func, fi.module):
                    f = index.make_finding(
                        "retrace-hazard", fi, child.lineno,
                        "a dispatch wrapper built and called at once is "
                        "discarded per call: its cache (signature table) "
                        "is keyed on the wrapper, so every invocation starts "
                        "cold")
                    if f:
                        out.append(f)
                if torch_dialect and dotted_name(child.func, fi.module) \
                        in _RAW_LIB_LOADS and not fi.module.relpath.endswith(
                            "ops/_build.py"):
                    f = index.make_finding(
                        "retrace-hazard", fi, child.lineno,
                        "kernel library loaded outside ops/_build.py's "
                        "cache: a load per call (and no source-digest check); "
                        "load through ops._build.load")
                    if f:
                        out.append(f)
            d = loop_depth + (1 if isinstance(child, (ast.For, ast.AsyncFor,
                                                      ast.While)) else 0)
            scan(fi, child, d)

    for q in sorted(index.functions):
        fi = index.functions[q]
        scan(fi, fi.node, 0)

    # traced closures over mutable module state: the captured value is baked
    # into the executable at trace time — later mutations are silently stale.
    # Eager torch re-reads a global on every run, so there the hazard is a
    # recompute reading another value: only globals something mutates count
    mutated = _mutated_globals(index) if torch_dialect else None
    for q in sorted(index.traced):
        fi = index.functions.get(q)
        if fi is None or isinstance(fi.node, ast.Module):
            continue
        local_binds = set(fi.params)
        for node in own_nodes(fi.node):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        local_binds.add(t.id)
        for node in own_nodes(fi.node):
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in fi.module.mutable_globals
                    and node.id not in local_binds
                    and (mutated is None
                         or (fi.module.dotted, node.id) in mutated)):
                f = index.make_finding(
                    "retrace-hazard", fi, node.lineno,
                    f"traced function reads mutable module state '{node.id}': "
                    + ("a recompute (remat, a second backward) may read "
                       "another value than the forward did" if torch_dialect
                       else "the value is baked in at trace time; later "
                            "mutations are silently ignored by the compiled "
                            "executable"))
                if f:
                    out.append(f)
    return out


def _mutated_globals(index: Index) -> Set[Tuple[str, str]]:
    """(module, name) of every mutable module global that a function of its
    module mutates (a mutator method, an item assignment, a ``global``
    rebinding)."""
    out: Set[Tuple[str, str]] = set()
    for fi in index.functions.values():
        sm = fi.module
        if isinstance(fi.node, ast.Module) or not sm.mutable_globals:
            continue
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in sm.mutable_globals \
                    and node.func.attr in MUTATOR_METHODS:
                out.add((sm.dotted, node.func.value.id))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, (ast.Assign, ast.Delete))
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                            and t.value.id in sm.mutable_globals:
                        out.add((sm.dotted, t.value.id))
            elif isinstance(node, ast.Global):
                out.update((sm.dotted, n) for n in node.names
                           if n in sm.mutable_globals)
    return out


# ---------------------------------------------------------------------------
# jit-purity
# ---------------------------------------------------------------------------


def _rule_jit_purity(index: Index) -> List[Finding]:
    out = []
    for q in sorted(index.traced):
        fi = index.functions.get(q)
        if fi is None or isinstance(fi.node, ast.Module):
            continue
        sm = fi.module
        torch_dialect = index.dialect.name == "torch"
        impure = _TORCH_IMPURE if torch_dialect else IMPURE_CALLS
        once = ("a recompute (remat, a second backward) runs the write "
                "again" if torch_dialect
                else "runs once per trace, not per call")
        for node in own_nodes(fi.node):
            f = None
            if isinstance(node, ast.Call):
                d = dotted_name(node.func, sm)
                draw = torch_dialect and not any(
                    k.arg == "generator" for k in node.keywords) and (
                    d in _TORCH_DRAWS or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _TORCH_DRAW_METHODS))
                if d in impure:
                    f = index.make_finding(
                        "jit-purity", fi, node.lineno,
                        f"{d}() inside a traced function: {impure[d]}")
                elif draw:
                    f = index.make_finding(
                        "jit-purity", fi, node.lineno,
                        f"{d or node.func.attr}() without generator= inside "
                        "a traced function: it draws from the global "
                        "generator, so remat's recompute (or a second "
                        "backward) draws other numbers than the forward")
                elif d and (d.startswith("numpy.random.")
                            or (d.startswith("random.")
                                and "random" in sm.imports)):
                    f = index.make_finding(
                        "jit-purity", fi, node.lineno,
                        f"{d}() inside a traced function: " + (
                            "the host generator draws other numbers in a "
                            "recompute (remat, a second backward); pass a "
                            "torch.Generator" if torch_dialect else
                            "host RNG draws once at trace time — every "
                            "compiled call replays the same 'random' "
                            "constant; thread jax.random keys instead"))
                elif (isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id in sm.mutable_globals
                      and node.func.attr in MUTATOR_METHODS):
                    f = index.make_finding(
                        "jit-purity", fi, node.lineno,
                        f"mutation of module state '{node.func.value.id}' "
                        f"inside a traced function: {once}")
            elif isinstance(node, ast.Global):
                f = index.make_finding(
                    "jit-purity", fi, node.lineno,
                    f"global {', '.join(node.names)} inside a traced "
                    f"function: {once}")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in sm.mutable_globals):
                        f = index.make_finding(
                            "jit-purity", fi, node.lineno,
                            f"item assignment into module state "
                            f"'{t.value.id}' inside a traced function: {once}")
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------------------------
# numpy-on-tracer
# ---------------------------------------------------------------------------


def _rule_numpy_on_tracer(index: Index) -> List[Finding]:
    out = []
    for q in sorted(index.traced):
        fi = index.functions.get(q)
        if fi is None or isinstance(fi.node, ast.Module):
            continue
        _, tainted = _device_taint(fi, index, seed_params=True)
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func, fi.module)
            if not d or not d.startswith("numpy."):
                continue
            tail = d.split(".", 1)[1]
            if tail.split(".")[0] in NP_METADATA_OK or tail.startswith("random."):
                continue
            if node.args and any(tainted(a) for a in node.args):
                f = index.make_finding(
                    "numpy-on-tracer", fi, node.lineno,
                    f"np.{tail} applied to a traced value: numpy raises on "
                    "a device (CUDA) tensor or a tracer and passes on the "
                    "CPU, where tests cannot see it; use the tensor library")
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------------------------
# monotonic-clock
# ---------------------------------------------------------------------------


_WALL_CLOCKS = {"time.time", "time.time_ns"}


def _rule_monotonic_clock(index: Index) -> List[Finding]:
    """Wall clock in duration/deadline arithmetic: ``time.time()`` (or a name
    assigned from it) fed into +/- or an ordering comparison. The wall clock
    steps under NTP slew/adjustment — elapsed-time math wants
    ``time.monotonic()`` or ``time.perf_counter()``. Value-only uses
    (timestamps recorded into logs/indices) are not flagged."""
    out = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        if isinstance(fi.node, ast.Module):
            continue
        sm = fi.module
        nodes = own_nodes(fi.node)

        wall_names: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and dotted_name(node.value.func, sm) in _WALL_CLOCKS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        wall_names.add(t.id)

        def is_wall(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Call) \
                    and dotted_name(expr.func, sm) in _WALL_CLOCKS:
                return True
            return isinstance(expr, ast.Name) and expr.id in wall_names

        for node in nodes:
            hit = False
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Sub)) \
                    and (is_wall(node.left) or is_wall(node.right)):
                hit = True
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                    for op in node.ops) \
                    and (is_wall(node.left)
                         or any(is_wall(c) for c in node.comparators)):
                hit = True
            if hit:
                f = index.make_finding(
                    "monotonic-clock", fi, node.lineno,
                    "time.time() in duration/deadline arithmetic: the wall "
                    "clock steps under NTP adjustment — use time.monotonic() "
                    "or time.perf_counter() for elapsed time")
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


def _lockish(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and "lock" in n.attr.lower():
            return True
        if isinstance(n, ast.Name) and "lock" in n.id.lower():
            return True
    return False


def _rule_lock_discipline(index: Index) -> List[Finding]:
    out = []
    for dotted in sorted(index.modules):
        sm = index.modules[dotted]
        if not sm.imports_threading or not sm.mutable_globals:
            continue
        for q in sorted(sm.functions):
            fi = sm.functions[q]
            if isinstance(fi.node, ast.Module):
                continue  # import-time mutation is single-threaded

            globals_decl: Set[str] = set()
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Global):
                    globals_decl.update(node.names)

            def mutation_of(node: ast.AST) -> Optional[str]:
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in sm.mutable_globals \
                        and node.func.attr in MUTATOR_METHODS:
                    return node.func.value.id
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id in sm.mutable_globals:
                            return t.value.id
                        if isinstance(t, ast.Name) and t.id in globals_decl \
                                and t.id in sm.mutable_globals:
                            return t.id
                if isinstance(node, ast.Delete):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id in sm.mutable_globals:
                            return t.value.id
                return None

            def scan(node: ast.AST, lock_depth: int):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        continue
                    d = lock_depth
                    if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                            _lockish(item.context_expr) for item in child.items):
                        d += 1
                    name = mutation_of(child)
                    if name is not None and lock_depth == 0:
                        f = index.make_finding(
                            "lock-discipline", fi, child.lineno,
                            f"module-level mutable '{name}' mutated without a "
                            "held lock in a threaded module: concurrent "
                            "callers race")
                        if f:
                            out.append(f)
                    scan(child, d)

            scan(fi.node, 0)
    out += _lock_hot_sync_findings(index)
    return out


def _lock_hot_sync_findings(index: Index) -> List[Finding]:
    """Second lock-discipline sub-check, for the serving scheduler's hot
    path: NO HOST SYNC (and no jitted dispatch) while holding a lock. A
    ``with <lock>:`` body that pulls a device value to host — device_get,
    ``.item()``, float/int/bool coercion, np.asarray, block_until_ready —
    or dispatches a jitted callable serializes every other thread behind
    XLA: producers can't even enqueue while the device runs. Admission
    math on host floats under the lock is fine; the device work must
    happen with the lock released (serve/scheduler.py's dispatch shape)."""
    out = []
    for dotted in sorted(index.modules):
        sm = index.modules[dotted]
        if not sm.imports_threading:
            continue
        for q in sorted(sm.functions):
            fi = sm.functions[q]
            if isinstance(fi.node, ast.Module):
                continue
            _, tainted = _device_taint(fi, index, seed_params=False)

            def sync_message(node: ast.AST) -> Optional[str]:
                if index.dialect.name == "torch":
                    msg = _sync_message(index, fi, node, tainted)
                    if msg:
                        return f"under a held lock, {msg}"
                if not isinstance(node, ast.Call):
                    return None
                d = dotted_name(node.func, sm)
                if d == "jax.device_get":
                    return ("jax.device_get under a held lock: every thread "
                            "queues behind the device→host transfer")
                if d in ("numpy.asarray", "numpy.array", "numpy.copy") \
                        and node.args and any(tainted(a) for a in node.args):
                    return (f"{d.replace('numpy', 'np')} on a device value "
                            "under a held lock: materialization blocks all "
                            "other lock holders")
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr == "block_until_ready":
                        return (".block_until_ready() under a held lock: "
                                "the lock is held for the whole device "
                                "execution")
                    if f.attr == "item" and not node.args \
                            and tainted(f.value):
                        return (".item() on a device value under a held "
                                "lock: synchronous host round-trip while "
                                "others wait")
                    if f.attr in index.jit_names:
                        return ("jitted dispatch under a held lock: XLA "
                                "execution serializes every other thread "
                                "on this lock")
                if isinstance(f, ast.Name):
                    if f.id in ("float", "int", "bool") and node.args \
                            and tainted(node.args[0]):
                        return (f"{f.id}() on a device value under a held "
                                "lock: blocks until the executable "
                                "finishes while others wait")
                    if f.id in index.jit_names \
                            and f.id in sm.global_names:
                        return ("jitted dispatch under a held lock: XLA "
                                "execution serializes every other thread "
                                "on this lock")
                return None

            def scan(node: ast.AST, lock_depth: int):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        continue
                    d = lock_depth
                    if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                            _lockish(item.context_expr)
                            for item in child.items):
                        d += 1
                    if lock_depth > 0:
                        msg = sync_message(child)
                        if msg:
                            f = index.make_finding("lock-discipline", fi,
                                                   child.lineno, msg)
                            if f:
                                out.append(f)
                    scan(child, d)

            scan(fi.node, 0)
    return out


# ---------------------------------------------------------------------------
# cost-analysis-off-hot-path
# ---------------------------------------------------------------------------

# trace-export entry points (obs/trace_export.py): serializing the whole span
# ring per call — report-time surfaces only
_TRACE_EXPORT_CALLS = {"live_trace", "trace_events"}

# the port's counting pass (obs/profile.py): a dispatch mode over every op
# of the call, milliseconds to seconds a pass
_COUNTING_CALLS = {"count_pass", "FlopCounterMode", "_bytes_mode"}

# fleet federation entry points (obs/fleet.py): each serializes the whole
# metrics registry + span summary and does store I/O (or scans every
# worker's snapshot) — report-time/boundary surfaces only, never per batch
_FLEET_CALLS = {"publish_snapshot", "collect_snapshots", "serve_collector"}


def _rule_cost_analysis_off_hot_path(index: Index) -> List[Finding]:
    """``cost_analysis()``/``memory_analysis()`` walk the lowered/compiled
    HLO modules host-side — milliseconds per call — the trace-export
    helpers serialize the whole span ring, and the fleet federation
    helpers (obs/fleet.py) additionally do store I/O. None belongs in
    traced bodies (baked in at trace time, re-run per compile) or
    per-batch dispatch code (latency per step). Harvest at compile time
    and render at report time instead (obs/profile.py, obs/trace_export.py,
    obs/fleet.py)."""
    out = []
    for q in sorted(index.traced | index.hot):
        fi = index.functions[q]
        where = "traced" if q in index.traced else "hot-path"
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            f = None
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "cost_analysis", "memory_analysis"):
                f = index.make_finding(
                    "cost-analysis-off-hot-path", fi, node.lineno,
                    f".{node.func.attr}() reachable from {where} code: walks "
                    "the executable's HLO host-side (milliseconds per call); "
                    "harvest once at compile/report time via obs.profile "
                    "instead")
            else:
                d = dotted_name(node.func, fi.module) or ""
                leaf = d.rsplit(".", 1)[-1] if d else (
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else node.func.id if isinstance(node.func, ast.Name)
                    else "")
                if leaf in _TRACE_EXPORT_CALLS or "trace_export." in d:
                    f = index.make_finding(
                        "cost-analysis-off-hot-path", fi, node.lineno,
                        f"trace export ({leaf or d}) reachable from {where} "
                        "code: serializes the span ring per call; export at "
                        "report time (/debug/trace, DL4J_TPU_SPAN_DUMP) "
                        "instead")
                elif index.dialect.name == "torch" \
                        and leaf in _COUNTING_CALLS:
                    f = index.make_finding(
                        "cost-analysis-off-hot-path", fi, node.lineno,
                        f"counting pass ({leaf}) reachable from {where} "
                        "code: a dispatch mode over every op of the call; "
                        "price a site once at warm time (nn/aot.py) and "
                        "read the ledger at report time instead")
                elif leaf in _FLEET_CALLS:
                    f = index.make_finding(
                        "cost-analysis-off-hot-path", fi, node.lineno,
                        f"fleet federation ({leaf}) reachable from {where} "
                        "code: serializes the metrics registry and does "
                        "store I/O per call; publish at step boundaries / "
                        "collect at report time (obs/fleet.py) instead")
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------------------------
# tuner-off-hot-path
# ---------------------------------------------------------------------------

# measurement/search entry points of deeplearning4j_tpu.tune: every one
# compiles executables, spawns trial subprocesses, or blocks on timers —
# offline surfaces by contract (tune.maybe_apply, a DB lookup plus env-var
# writes, is the ONLY tune call allowed near the hot path)
_TUNER_MEASURE_CALLS = {
    "run_trial", "run_subprocess_trial", "successive_halving", "tune_model",
}


def _rule_tuner_off_hot_path(index: Index) -> List[Finding]:
    """The auto-tuner's search/trial surfaces measure by running: a trial
    compiles a fresh step executable, a search spawns subprocesses and
    waits on them. Reachable from a traced body that means host calls baked
    in at trace time; reachable from per-batch dispatch code it means
    seconds of stall per step. Tuning is an offline phase — consult its
    RESULTS online via tune.maybe_apply (env-var application at startup),
    never the measurement itself."""
    out = []
    for q in sorted(index.traced | index.hot):
        fi = index.functions[q]
        # the tuner's own modules call these entry points as the offline
        # flow itself (tune_model → halving → subprocess trial → fit);
        # self-calls are the feature, not a hot-path leak
        if "/tune/" in fi.module.path.replace("\\", "/"):
            continue
        where = "traced" if q in index.traced else "hot-path"
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func, fi.module) or ""
            leaf = d.rsplit(".", 1)[-1] if d else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name)
                else "")
            if leaf in _TUNER_MEASURE_CALLS:
                f = index.make_finding(
                    "tuner-off-hot-path", fi, node.lineno,
                    f"tuner measurement ({leaf}) reachable from {where} "
                    "code: trials compile executables and spawn "
                    "subprocesses; tune offline and consult the DB via "
                    "tune.maybe_apply at startup instead")
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------------------------
# step-wiring: compiled-step construction outside the step-program module
# ---------------------------------------------------------------------------


def _rule_step_wiring(index: Index) -> List[Finding]:
    """JAX dialect: direct ``jax.jit(..., donate_argnums=...)`` in ``nn/``
    or ``parallel/`` outside ``nn/step_program.py``. A donated-carry jit IS
    a training/serving step executable, and the framework's step wiring
    (trace sites, AOT warm registration, retrace-guard hookup, the
    grad-accumulation scan) lives in exactly one place — ``StepProgram``.

    Torch dialect: the port's step updates params and updater state in
    place under ``torch.no_grad()``; an in-place update of that kind in
    ``nn/`` or ``parallel/`` outside :data:`STEP_MODULES` forks the step,
    and misses its guards (the donation guard, the skip_batch select)."""
    if index.dialect.name == "torch":
        return _torch_step_wiring(index)
    out = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        p = "/" + fi.module.relpath.replace("\\", "/")
        if "/nn/" not in p and "/parallel/" not in p:
            continue
        if p.endswith("/step_program.py"):
            continue
        for node in own_nodes(fi.node):
            if not (isinstance(node, ast.Call) and index.is_jit_call(node, fi.module)):
                continue
            if not any(kw.arg == "donate_argnums" for kw in node.keywords):
                continue
            f = index.make_finding(
                "step-wiring", fi, node.lineno,
                "donated-carry jit built outside nn/step_program.py: step "
                "executables must go through StepProgram so trace/donate/"
                "AOT-warm/retrace-guard policy stays in one place")
            if f:
                out.append(f)
    return out


def _torch_step_wiring(index: Index) -> List[Finding]:
    out = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        p = "/" + fi.module.relpath.replace("\\", "/")
        if "/nn/" not in p and "/parallel/" not in p:
            continue
        if any(p.endswith("/" + m) for m in STEP_MODULES):
            continue
        sm = fi.module

        def scan(node: ast.AST, no_grad: bool):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                ng = no_grad or (isinstance(child, (ast.With, ast.AsyncWith))
                                 and any(dotted_name(
                                     i.context_expr.func if isinstance(
                                         i.context_expr, ast.Call)
                                     else i.context_expr, sm) == "torch.no_grad"
                                     for i in child.items))
                if no_grad and isinstance(child, ast.Call) \
                        and isinstance(child.func, ast.Attribute) \
                        and child.func.attr in _INPLACE_UPDATES:
                    f = index.make_finding(
                        "step-wiring", fi, child.lineno,
                        f"in-place .{child.func.attr}() under torch.no_grad() "
                        "outside the step's modules: an update of params or "
                        "updater state here forks the step and skips its "
                        "guards (donation guard, skip_batch select)")
                    if f:
                        out.append(f)
                scan(child, ng)

        scan(fi.node, False)
    return out
