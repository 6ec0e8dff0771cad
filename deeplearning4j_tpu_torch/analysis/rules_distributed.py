"""graftlint distributed-correctness rules (the dataflow-backed families).

Counterpart of ``deeplearning4j_tpu/analysis/rules_distributed.py``, in
the dialects of ``engine.Dialect`` (the torch forms: ``rules.py``'s table).

| rule                   | hazard                                              |
|------------------------|-----------------------------------------------------|
| use-after-donate       | read of a buffer already donated into a step        |
| collective-consistency | rank-divergent / axis-mismatched collectives        |
| durable-store-protocol | raw writes to checkpoint/bundle/store paths         |

All three run on :class:`analysis.dataflow.Dataflow` — the interprocedural,
field-sensitive layer over the engine's call graph — so a donation through
``self._step`` built in ``__init__``, a helper that donates its parameter,
or a durable path handed down two calls all resolve. Inline
``# graftlint: disable=<rule>`` suppressions are honored via
``Index.make_finding`` like every other rule.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.dataflow import (
    Dataflow,
    Key,
    key_of,
    leaf_alias_base,
    ordered_statements,
    render_key,
    string_constants,
)
from deeplearning4j_tpu_torch.analysis.engine import (
    Finding,
    FunctionInfo,
    Index,
    dotted_name,
    own_nodes,
)

__all__ = [
    "DISTRIBUTED_RULES",
    "run_distributed",
]

DISTRIBUTED_RULES = (
    "use-after-donate",
    "collective-consistency",
    "durable-store-protocol",
)


def run_distributed(index: Index,
                    rules: Optional[Sequence[str]] = None) -> List[Finding]:
    active = set(rules) if rules else set(DISTRIBUTED_RULES)
    df = index.dataflow
    out: List[Finding] = []
    if "use-after-donate" in active:
        out += (_rule_use_after_step(index, df) if index.dialect.name == "torch"
                else _rule_use_after_donate(index, df))
    if "collective-consistency" in active:
        out += _rule_collective_consistency(index)
    if "durable-store-protocol" in active:
        out += _rule_durable_store_protocol(index, df)
    return out


# ---------------------------------------------------------------------------
# statement-scan plumbing shared by the rules
# ---------------------------------------------------------------------------

# statements whose full subtree is scanned (no nested statements inside);
# compound statements contribute only their header expressions — their body
# statements are visited on their own through the flattened statement list
_SIMPLE = (ast.Expr, ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Return,
           ast.Raise, ast.Assert, ast.Delete)


def _scan_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions a statement evaluates at its own source position."""
    if isinstance(stmt, _SIMPLE):
        return [stmt]
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    return []


def _kill_keys(stmt: ast.stmt) -> Set[Key]:
    """Keys (re)bound or deleted by a statement — optimistic kills."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    out: Set[Key] = set()

    def add(t: ast.AST):
        k = key_of(t)
        if k:
            out.add(k)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add(e)
        elif isinstance(t, ast.Starred):
            add(t.value)

    for t in targets:
        add(t)
    return out


def _keys_mentioned(node: ast.AST) -> Set[Key]:
    out: Set[Key] = set()
    for n in ast.walk(node):
        k = key_of(n)
        if k:
            out.add(k)
    return out


def _is_barrier_call(node: ast.AST, fi: FunctionInfo) -> bool:
    """``jax.block_until_ready(...)`` / ``<x>.block_until_ready()`` — the
    sanctioned host-side sync that pins a value before/around donation."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr == "block_until_ready":
        return True
    return dotted_name(node.func, fi.module) == "jax.block_until_ready"


# ---------------------------------------------------------------------------
# use-after-donate
# ---------------------------------------------------------------------------


def _alias_base(value: ast.AST) -> Optional[Key]:
    """The key a plain alias expression reads from: ``y``, ``y.attr``,
    ``y[...]`` / ``y.attr[...]``. Donating the alias kills the base's
    buffer too — rebinding the alias does not resurrect it."""
    if isinstance(value, ast.Subscript):
        return key_of(value.value)
    return key_of(value)


def _rule_use_after_donate(index: Index, df: Dataflow) -> List[Finding]:
    """A value passed at a donated position of a step dispatch is dead: the
    executable owns (or aliased away) its buffer. Any later read on a path
    without a rebind or an explicit ``block_until_ready`` barrier is flagged
    — on TPU/GPU that read returns garbage or raises; on CPU, where XLA may
    ignore donation, it silently reads a stale buffer
    (``DL4J_TPU_DONATION_GUARD=1`` turns that into a loud failure). Aliases
    are tracked one level deep: donating ``x`` bound from ``base.attr[...]``
    kills ``base.attr`` as well."""
    out: List[Finding] = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        sites = df.dispatch_sites(fi)
        if not sites:
            continue
        by_stmt: Dict[int, list] = {}
        for s in sites:
            by_stmt.setdefault(id(s.stmt), []).append(s)

        stmts = ordered_statements(fi)
        loops = [(n.lineno, getattr(n, "end_lineno", n.lineno) or n.lineno)
                 for n in own_nodes(fi.node)
                 if isinstance(n, (ast.For, ast.AsyncFor, ast.While))]
        dead: Dict[Key, tuple] = {}      # key -> (site, donate position)
        killed_at: Dict[Key, List[int]] = {}   # key -> kill/sanction lines
        flagged: Set[Tuple[Key, int]] = set()
        alias_of: Dict[Key, Key] = {}    # key -> base it aliases
        # alias bases dead at each site's dispatch, for the loop-carry pass
        site_alias: Dict[Tuple[int, int], Key] = {}

        for stmt in stmts:
            exprs = _scan_exprs(stmt)
            # 1) barrier sanction: block_until_ready naming a dead key
            #    re-legitimizes it (the JAX package's barrier placements)
            for e in exprs:
                for n in ast.walk(e):
                    if _is_barrier_call(n, fi):
                        for k in _keys_mentioned(n):
                            if dead.pop(k, None) is not None:
                                killed_at.setdefault(k, []).append(stmt.lineno)
            # 2) reads of dead keys
            for e in exprs:
                for n in ast.walk(e):
                    if not isinstance(n, (ast.Name, ast.Attribute)):
                        continue
                    if not isinstance(getattr(n, "ctx", None), ast.Load):
                        continue
                    k = key_of(n)
                    if k is None or k not in dead:
                        continue
                    site, pos = dead.pop(k)
                    if (k, site.call.lineno) in flagged:
                        continue
                    flagged.add((k, site.call.lineno))
                    f = index.make_finding(
                        "use-after-donate", fi, n.lineno,
                        f"'{render_key(k)}' was donated at line "
                        f"{site.call.lineno} (arg {pos} of "
                        f"{site.donation.desc}) and is dead here: rebind it "
                        "from the dispatch outputs or barrier with "
                        "jax.block_until_ready before reuse")
                    if f:
                        out.append(f)
            # 3) new dispatches, against the PRE-statement alias state (the
            #    RHS donates before the LHS rebinds). Donated keys rebound
            #    by this very statement stay live — `p, _ = step(p, x)` is
            #    the sanctioned idiom — but an aliased base dies regardless.
            for site in by_stmt.get(id(stmt), ()):
                own = _kill_keys(stmt)
                for pos, k, arg in site.donated:
                    base = _alias_base(arg) if k is None else alias_of.get(k)
                    if base is not None and base not in own \
                            and base not in dead:
                        dead[base] = (site, pos)
                        site_alias[(id(site), pos)] = base
                    if k is None or k in own:
                        continue
                    dead[k] = (site, pos)
            # 4) kills: rebinding / del ends tracking (and dissolves any
            #    alias relationship the old binding carried)
            for k in _kill_keys(stmt):
                if k in dead and dead[k][0].stmt is not stmt:
                    dead.pop(k)
                killed_at.setdefault(k, []).append(stmt.lineno)
                alias_of.pop(k, None)
            # 4b) alias bindings: `x = base.attr[...]` — donating x later
            #     kills base.attr's buffer no matter what x rebinds to
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tk = key_of(stmt.targets[0])
                bk = _alias_base(stmt.value)
                if tk and bk and bk != tk:
                    alias_of[tk] = bk

        # 5) loop carry: a donated key (or the base it aliases) never
        #    rebound before the loop's next iteration touches a dead buffer
        for site in sites:
            line = site.call.lineno
            enclosing = [(a, b) for a, b in loops if a <= line <= b]
            if not enclosing:
                continue
            _, loop_end = min(enclosing, key=lambda ab: ab[1] - ab[0])
            own = _kill_keys(site.stmt)
            for pos, k, _arg in site.donated:
                carried = []
                if k is not None and k not in own:
                    carried.append((k, False))
                base = site_alias.get((id(site), pos))
                if base is not None and base not in own:
                    carried.append((base, True))
                for ck, is_alias in carried:
                    if (ck, line) in flagged:
                        continue
                    if any(line < kl <= loop_end
                           for kl in killed_at.get(ck, ())):
                        continue
                    flagged.add((ck, line))
                    via = (f" (via its alias donated as arg {pos})"
                           if is_alias else f" (arg {pos})")
                    f = index.make_finding(
                        "use-after-donate", fi, line,
                        f"'{render_key(ck)}' is donated here{via} into "
                        f"{site.donation.desc} inside a loop but never "
                        "rebound before the next iteration can touch the "
                        "dead buffer; rebind it from the outputs "
                        "(`x, ... = step(x, ...)`) or copy before donating")
                    if f:
                        out.append(f)
    return out


def _rule_use_after_step(index: Index, df: Dataflow) -> List[Finding]:
    """Torch dialect: the port's step updates a model's params, updater
    state and layer state in place (where the JAX step donates them). A
    name bound to such a leaf before a step (``w = m.params[0]["W"]``,
    with no ``.clone()``) holds the NEW values after ``m.fit_batch(...)``:
    a read of it "as the old value" is silently wrong, on every backend.
    Rebinding the name ends the tracking."""
    out: List[Finding] = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        stmts = ordered_statements(fi)
        if not any(isinstance(st, ast.Assign) and leaf_alias_base(st.value)
                   for st in stmts):
            continue
        aliases: Dict[str, str] = {}          # name -> receiver it aliases
        stale: Dict[str, int] = {}            # name -> step line
        flagged: Set[Tuple[str, int]] = set()
        for stmt in stmts:
            exprs = _scan_exprs(stmt)
            # 1) reads of names a step made stale
            for e in exprs:
                for n in ast.walk(e):
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                            and n.id in stale:
                        line = stale.pop(n.id)
                        if (n.id, line) in flagged:
                            continue
                        flagged.add((n.id, line))
                        f = index.make_finding(
                            "use-after-donate", fi, n.lineno,
                            f"'{n.id}' aliases {aliases.get(n.id, '?')}'s "
                            f"leaves, which the in-place step at line {line} "
                            "rewrote: it reads the NEW values here; take a "
                            ".clone() before the step to keep the old ones")
                        if f:
                            out.append(f)
            # 2) steps in this statement make every alias of their receiver
            #    stale (the RHS steps before the LHS rebinds)
            for e in exprs:
                for n in ast.walk(e):
                    if not isinstance(n, ast.Call):
                        continue
                    for recv in df.step_receivers(fi, n):
                        for name, base in aliases.items():
                            if base == recv:
                                stale[name] = n.lineno
            # 3) rebinding ends tracking; a plain alias binding starts it
            for k in _kill_keys(stmt):
                if k[0] == "local":
                    aliases.pop(k[1], None)
                    stale.pop(k[1], None)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                base = leaf_alias_base(stmt.value)
                if base is not None:
                    aliases[stmt.targets[0].id] = base
    return out


# ---------------------------------------------------------------------------
# collective-consistency
# ---------------------------------------------------------------------------

# cross-replica primitives that must be issued identically by every member
# of the axis (arXiv 2004.13336's sharded update is bit-exact only then;
# mismatches are the gloo-preamble / gpipe-clip taxonomies of TEST_DEBT.md)
_COLLECTIVES = {
    "jax": {"psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
            "ppermute", "pshuffle", "psum_scatter", "pcast", "pvary"},
    # torch.distributed's collectives and parallel/comm.py's wrappers
    "torch": {"all_reduce", "all_gather", "all_gather_into_tensor",
              "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
              "broadcast", "broadcast_object_list", "barrier", "all_to_all",
              "all_to_all_single", "reduce", "gather", "scatter", "send",
              "recv", "all_reduce_sum", "copy_to", "reduce_from",
              "gather_dim"},
}
# the modules whose names mark a call as a collective
_COLLECTIVE_MODULES = {"jax": {"lax", "jax"}, "torch": {"distributed", "comm"}}
_RANK_SOURCES_LEAF = {"jax": {"axis_index", "process_index"},
                      "torch": {"get_rank", "get_local_rank",
                                "get_node_local_rank"}}
# torch: attribute reads that name this member (a context's or a mesh's rank)
_RANK_ATTRS = {"jax": set(), "torch": {"rank"}}


def _collective_leaf(node: ast.Call, fi: FunctionInfo,
                     dialect: str = "jax") -> Optional[str]:
    d = dotted_name(node.func, fi.module) or ""
    leaf = d.rsplit(".", 1)[-1]
    if leaf not in _COLLECTIVES[dialect]:
        return None
    parts = d.split(".")
    if _COLLECTIVE_MODULES[dialect] & set(parts) or d == leaf:
        return leaf
    return None


def _is_rank_source(node: ast.AST, fi: FunctionInfo,
                    dialect: str = "jax") -> bool:
    if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
        return node.attr in _RANK_ATTRS[dialect]
    if not isinstance(node, ast.Call):
        return False
    d = dotted_name(node.func, fi.module) or ""
    return d.rsplit(".", 1)[-1] in _RANK_SOURCES_LEAF[dialect]


def _rank_tainted_names(fi: FunctionInfo, dialect: str = "jax") -> Set[str]:
    """Names carrying a member-identity value (axis_index/process_index),
    propagated through straight-line assignments."""
    tainted: Set[str] = set()

    def expr_tainted(e: ast.AST) -> bool:
        for n in ast.walk(e):
            if _is_rank_source(n, fi, dialect):
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tainted:
                return True
        return False

    nodes = own_nodes(fi.node)
    for _ in range(2):
        before = len(tainted)
        for node in nodes:
            if isinstance(node, ast.Assign) and expr_tainted(node.value):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
        if len(tainted) == before:
            break
    return tainted


def _collective_scope(index: Index) -> Tuple[Set[str], Dict[str, Set[str]]]:
    """(functions to check, axis-name environment per function).

    Scope: anything containing a collective or rank source, plus everything
    reachable from a ``shard_map`` body. The env maps body functions to the
    literal axis names visible at their shard_map call sites (in_specs /
    out_specs / axis kwargs), unioned over sites and propagated down the
    call graph."""
    dia = index.dialect.name
    scope: Set[str] = set()
    roots_env: Dict[str, Set[str]] = {}
    for q, fi in index.functions.items():
        has = False
        for node in own_nodes(fi.node):
            if _is_rank_source(node, fi, dia) or (isinstance(node, ast.Call)
                                                  and _collective_leaf(node, fi, dia)):
                has = True
            if isinstance(node, ast.Call):
                d = dotted_name(node.func, fi.module) or ""
                if d.rsplit(".", 1)[-1] == "shard_map" and node.args:
                    axes: Set[str] = set()
                    for a in list(node.args[1:]) + [k.value for k in
                                                    node.keywords]:
                        axes.update(s for s in string_constants(a) if s)
                    for root in index._roots_from(fi, node.args[0], 0):
                        roots_env.setdefault(root, set()).update(axes)
        if has:
            scope.add(q)
    env: Dict[str, Set[str]] = {}
    for root, axes in roots_env.items():
        for q in index._reach({root}, index.edges):
            env.setdefault(q, set()).update(axes)
            scope.add(q)
    return scope, env


def _axis_literals(call: ast.Call) -> List[str]:
    """Literal axis names of a collective call (positional arg 1 or the
    axis_name/axis_index_groups-adjacent kwargs); [] when computed."""
    expr: Optional[ast.AST] = None
    for kw in call.keywords:
        if kw.arg in ("axis_name", "axis"):
            expr = kw.value
    if expr is None and len(call.args) > 1:
        expr = call.args[1]
    if expr is None:
        return []
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, (ast.Tuple, ast.List)):
        vals = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                vals.append(e.value)
            else:
                return []   # mixed/computed: refuse to guess
        return vals
    return []


def _branch_collective_seq(index: Index, fi: FunctionInfo,
                           expr: ast.AST) -> Optional[Tuple[str, ...]]:
    """Ordered collective ops a cond/switch branch issues; None when the
    branch cannot be resolved statically."""
    if isinstance(expr, ast.Lambda):
        return tuple(_collective_leaf(n, fi)
                     for n in ast.walk(expr.body)
                     if isinstance(n, ast.Call) and _collective_leaf(n, fi))
    if isinstance(expr, ast.Call):
        d = dotted_name(expr.func, fi.module) or ""
        if d.rsplit(".", 1)[-1] == "partial" and expr.args:
            return _branch_collective_seq(index, fi, expr.args[0])
        return None
    if isinstance(expr, (ast.Name, ast.Attribute)):
        hits = (index.resolve_call(fi, expr)
                if isinstance(expr, ast.Attribute)
                else ([index._resolve_local(fi, expr.id)]
                      if index._resolve_local(fi, expr.id) else []))
        if len(hits) != 1:
            return None
        cfi = index.functions.get(hits[0])
        if cfi is None:
            return None
        return tuple(_collective_leaf(n, cfi)
                     for n in own_nodes(cfi.node)
                     if isinstance(n, ast.Call) and _collective_leaf(n, cfi))
    return None


def _rule_collective_consistency(index: Index) -> List[Finding]:
    """Inside mesh/shard_map step bodies every member of an axis must issue
    the SAME collective sequence with the SAME axis names — a collective
    under rank-dependent control flow, a branch whose arms diverge, or an
    axis name outside the mesh's set deadlocks or miscompiles (the
    gloo-preamble rank disagreement and the gpipe-clip GSPMD taxonomies,
    docs/TEST_DEBT.md)."""
    out: List[Finding] = []
    dia = index.dialect.name
    scope, env = _collective_scope(index)
    for q in sorted(scope):
        fi = index.functions[q]
        tainted = _rank_tainted_names(fi, dia)

        def test_ranky(e: ast.AST) -> bool:
            for n in ast.walk(e):
                if _is_rank_source(n, fi, dia):
                    return True
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                        and n.id in tainted:
                    return True
            return False

        # (a) collectives lexically under rank-dependent control flow
        def scan(node: ast.AST, under_rank: bool):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                u = under_rank
                if isinstance(child, (ast.If, ast.While, ast.IfExp)) \
                        and test_ranky(child.test):
                    u = True
                if under_rank and isinstance(child, ast.Call):
                    leaf = _collective_leaf(child, fi, dia)
                    if leaf:
                        f = index.make_finding(
                            "collective-consistency", fi, child.lineno,
                            f"collective {leaf} under rank-dependent control "
                            "flow (a branch on the member's rank): members "
                            "that skip it deadlock the group or corrupt the "
                            "collective's matching (gloo-preamble class); "
                            "hoist the collective out of the branch")
                        if f:
                            out.append(f)
                scan(child, u)

        scan(fi.node, False)

        if dia == "torch":
            continue   # (b) and (c) read shard_map axes and lax branches

        # (b) axis-name literal checks against the shard_map site env
        fenv = env.get(q, set())
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            leaf = _collective_leaf(node, fi)
            if leaf:
                lits = _axis_literals(node)
                dup = {a for a in lits if lits.count(a) > 1}
                if dup:
                    f = index.make_finding(
                        "collective-consistency", fi, node.lineno,
                        f"lax.{leaf} repeats axis name(s) "
                        f"{sorted(dup)} in one axis spec: reducing an axis "
                        "twice is at best redundant, at worst a "
                        "shadowed-axis bug")
                    if f:
                        out.append(f)
                if fenv:
                    missing = [a for a in lits if a not in fenv]
                    if missing:
                        f = index.make_finding(
                            "collective-consistency", fi, node.lineno,
                            f"lax.{leaf} names axis {missing} but the "
                            f"enclosing shard_map binds {sorted(fenv)}: "
                            "unbound or shadowed axis names fail at trace "
                            "time on some paths and silently no-op on "
                            "others")
                        if f:
                            out.append(f)

            # (c) rank-selected branch arms with divergent (or unverifiable)
            # collective sequences
            d = dotted_name(node.func, fi.module) or ""
            if d.rsplit(".", 1)[-1] in ("cond", "switch") \
                    and ("lax" in d.split(".")) and len(node.args) >= 2:
                branch_exprs: List[ast.AST] = []
                if isinstance(node.args[1], (ast.Tuple, ast.List)):
                    branch_exprs = list(node.args[1].elts)
                elif d.rsplit(".", 1)[-1] == "cond" and len(node.args) >= 3:
                    branch_exprs = [node.args[1], node.args[2]]
                else:
                    branch_exprs = [node.args[1]]
                seqs = [_branch_collective_seq(index, fi, b)
                        for b in branch_exprs]
                ranky = test_ranky(node.args[0])
                if all(x is not None for x in seqs) and len(set(seqs)) > 1:
                    f = index.make_finding(
                        "collective-consistency", fi, node.lineno,
                        f"lax.{d.rsplit('.', 1)[-1]} branch arms issue "
                        f"different collective sequences "
                        f"({[list(x) for x in seqs]}): all arms trace into "
                        "one program, so their collectives must match "
                        "exactly (gpipe-clip class)")
                    if f:
                        out.append(f)
                elif ranky and any(x is None for x in seqs):
                    f = index.make_finding(
                        "collective-consistency", fi, node.lineno,
                        f"rank-selected lax.{d.rsplit('.', 1)[-1]} whose "
                        "branches cannot be statically shown to issue "
                        "identical collective sequences; verify the arms "
                        "are collective-free (or normalized, e.g. pvary) "
                        "and suppress")
                    if f:
                        out.append(f)
    if dia == "torch":
        out += _foreign_groups(index)
    return out


def _foreign_groups(index: Index) -> List[Finding]:
    """Torch dialect: every process group comes from ``parallel/mesh.py``,
    which creates each sub-group on every rank in one order
    (``dist.new_group`` is itself a collective); a group made elsewhere can
    miss members or order, and hang them."""
    out: List[Finding] = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        if fi.module.relpath.endswith("parallel/mesh.py"):
            continue
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Call) and (dotted_name(
                    node.func, fi.module) or "").endswith("distributed.new_group"):
                f = index.make_finding(
                    "collective-consistency", fi, node.lineno,
                    "process group created outside parallel/mesh.py: "
                    "new_group is a collective every rank must call in one "
                    "order; take the group from the Mesh (mesh.sub)")
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------------------------
# durable-store-protocol
# ---------------------------------------------------------------------------

_RAW_SAVERS = {"jax": {"numpy.save", "numpy.savez", "numpy.savez_compressed"},
               "torch": {"numpy.save", "numpy.savez", "numpy.savez_compressed",
                         "torch.save"}}
_WRITE_METHODS = {"write_text", "write_bytes"}


def _open_mode(call: ast.Call) -> str:
    expr: Optional[ast.AST] = None
    if len(call.args) > 1:
        expr = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            expr = kw.value
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    return "r" if expr is None else ""


def _rule_durable_store_protocol(index: Index, df: Dataflow) -> List[Finding]:
    """Writes reaching FileStore blob / checkpoint / bundle / tune-DB paths
    must go through the CRC-framed atomic helpers (``_atomic_write_zip``,
    DLES framing, write-tmp-then-``os.replace``): a raw ``open(path, "w")``
    or ``np.save`` on a durable path tears under crash/preemption and the
    reader sees a half-written artifact (docs/ROBUSTNESS.md). Exclusive
    create must spell ``os.link`` (atomic on POSIX *and* NFS), not
    ``open(..., "x")``."""
    out: List[Finding] = []
    for q in sorted(index.functions):
        fi = index.functions[q]
        durable = df.durable_names(fi)
        sanctioned = df.replace_sanctioned(fi)

        def flagged_path(expr: ast.AST) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Name) and n.id in sanctioned:
                    return False   # the tmp half of tmp -> os.replace
            return df.expr_durable(fi, expr, durable)

        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func, fi.module) or ""
            f = None
            if d in ("open", "io.open", "builtins.open") and node.args:
                mode = _open_mode(node)
                writes = any(c in mode for c in "wax+")
                if writes and flagged_path(node.args[0]):
                    if "x" in mode:
                        f = index.make_finding(
                            "durable-store-protocol", fi, node.lineno,
                            "exclusive-create open(..., 'x') on a durable "
                            "path: O_EXCL is not atomic on NFS and leaves a "
                            "partial file on crash; publish via write-tmp "
                            "then os.link (FileStore.set_exclusive)")
                    else:
                        f = index.make_finding(
                            "durable-store-protocol", fi, node.lineno,
                            f"raw open(..., {mode!r}) on a durable path: a "
                            "crash mid-write tears the artifact for every "
                            "reader; write a tmp file and os.replace it "
                            "(utils.serialization._atomic_write_zip / "
                            "FileStore framing)")
            elif d in _RAW_SAVERS[index.dialect.name] and node.args \
                    and flagged_path(node.args[0 if d.startswith("numpy") else
                                               min(1, len(node.args) - 1)]):
                f = index.make_finding(
                    "durable-store-protocol", fi, node.lineno,
                    f"{d.replace('numpy', 'np')} straight onto a durable "
                    "path: the write is not atomic — save to a tmp path "
                    "and os.replace, or route through the checkpoint "
                    "helpers")
            elif index.dialect.name == "torch" and d == "zipfile.ZipFile" \
                    and node.args and any(c in _open_mode(node) for c in "wax") \
                    and flagged_path(node.args[0]):
                f = index.make_finding(
                    "durable-store-protocol", fi, node.lineno,
                    "zipfile.ZipFile(..., 'w') straight onto a durable path: "
                    "a crash mid-write tears the archive; write a tmp zip "
                    "and os.replace it (utils.serialization)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _WRITE_METHODS \
                    and flagged_path(node.func.value):
                f = index.make_finding(
                    "durable-store-protocol", fi, node.lineno,
                    f".{node.func.attr}() on a durable path: not atomic; "
                    "write tmp then os.replace")
            if f:
                out.append(f)
    return out
