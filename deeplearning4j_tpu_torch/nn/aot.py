"""The warm layer and the bundle sidecar (PyTorch port of ``nn/aot.py``).

The JAX package compiles every (bucket, variant) of its step and output
paths ahead of time and persists the executables in a CRC'd zip beside
checkpoints. PyTorch runs eagerly, so nothing is compiled; what a cold
start still costs on the card is the first dispatch of every shape: the
kernel libraries' load (``ops/_build.py``), cuBLAS / cuDNN heuristics per
shape, the caching allocator's growth, and the counting pass that prices a
site (``obs/profile.py``). This module keeps those off the request and
step path:

1. **Sites.** :class:`AotFunction` wraps one dispatch site of a model
   (``mln.output``, ``mln.step``, ``mln.step.tbptt``, ``cg.*``,
   ``decode.step``, the search tiers) and records its signatures: the
   *warmed* ones (a warm pass ran them, priced by a counting pass) and the
   ones *seen* lazily on the dispatch path. A warm runs one dispatch per
   signature; on a training site it runs on a snapshot of params, updater
   state, layer state, counters and generator, all restored afterwards,
   so a warm never trains. Warmed dispatches on a card are the ones
   ``obs/profile.py`` samples for device time.

2. **Warmers.** :func:`warm_serving` walks the bucket ladder of the
   inference path, :func:`warm_fit` runs the first step fit() will take,
   :func:`warm_dp` a data-parallel step, :func:`warm_serving_bundled` the
   serving tier's restore → warm → persist pipeline.

3. **Bundles.** :func:`save_bundle` writes the site table as a zip with
   the JAX package's layout: a CRC'd ``manifest.json`` (``format_version``
   :data:`BUNDLE_FORMAT_VERSION`, the toolchain fingerprint, the model
   signature) and one JSON entry per (site, signature) holding its
   cost-ledger entry. No executables and no pickles: a restored process
   replays exactly the recorded inference grid, lazily seen shapes
   included, takes the recorded training signatures as warm (their first
   real step is their warm-up), and has every cost without a second
   counting pass. :func:`restore_bundle` reads
   JSON only; a bundle of the JAX package (pickled executables) is
   rejected by its fingerprint before any entry is read, and the JAX
   package's ``restore_bundle`` rejects a port bundle the same way. Every
   rejection counts ``dl4j_aot_bundle_rejected_total{reason}``, emits
   ``aot_bundle_rejected`` and leaves the warm to the ladder.

Env knobs (read per call):

- ``DL4J_TPU_AOT``          the implicit warm hooks in ``fit()`` /
                            ``ParallelInference`` (default 0)
- ``DL4J_TPU_AOT_BUNDLE``   bundles: ``0`` off, ``1`` on once
                            :func:`validate_persistence` passes, ``auto``
                            (default) on for CUDA models and off on the
                            CPU.

Not here yet: the cross-registration of warmed buckets with the JAX
package's retrace guard (``analysis/``), ROADMAP Queue 1 item 9.5.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import sys
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import profile as _profile
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "AotFunction",
    "BUNDLE_FORMAT_VERSION",
    "bundle_path_for",
    "distributed_bundle_manifest",
    "distributed_bundle_path",
    "enabled",
    "grid_site",
    "model_signature",
    "persistence_allowed",
    "reachable_buckets",
    "restore_bundle",
    "restore_distributed_bundle",
    "save_bundle",
    "save_distributed_bundle",
    "signature_key",
    "toolchain_fingerprint",
    "validate_persistence",
    "warm_dp",
    "warm_fit",
    "warm_serving",
    "warm_serving_bundled",
    "wrap",
]

BUNDLE_FORMAT_VERSION = 2
_MANIFEST_ENTRY = "manifest.json"
reachable_buckets = bucketing.reachable_buckets


def enabled() -> bool:
    """The implicit warm hooks (fit / ParallelInference); default off."""
    return os.environ.get("DL4J_TPU_AOT", "0") == "1"


# ---------------------------------------------------------------------------
# Signature keys
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaf_sig(x):
    if x is None:
        return ("n",)
    if isinstance(x, torch.Tensor):
        return ("t", tuple(int(s) for s in x.shape), _dtype_name(x.dtype))
    if isinstance(x, np.ndarray):
        return ("a", tuple(int(s) for s in x.shape), x.dtype.name)
    if isinstance(x, dict):
        return ("d", tuple((str(k), _leaf_sig(x[k])) for k in sorted(x)))
    if isinstance(x, (tuple, list)):
        return ("s", tuple(_leaf_sig(v) for v in x))
    if isinstance(x, (bool, int, float, str)):
        return ("v", x)
    raise TypeError(f"no signature for a {type(x).__name__} argument")


def signature_key(args: tuple, kwargs: Optional[dict] = None) -> Tuple:
    """Hashable call signature: the argument structure with each tensor's
    (shape, dtype) and each plain value itself — what decides whether a
    dispatch meets a shape its site has run before."""
    return _leaf_sig((tuple(args), dict(kwargs or {})))


def _freeze(obj):
    """JSON lists back to the tuples a key is made of."""
    if isinstance(obj, list):
        return tuple(_freeze(v) for v in obj)
    return obj


def _sig_label(key: Tuple) -> str:
    """Stable short label of a signature (the same in every process)."""
    digest = hashlib.sha1(json.dumps(key).encode()).hexdigest()
    return f"sig{int(digest[:12], 16) % 10**8:08d}"


def _materialize(sig, device):
    """Zero arguments of a recorded signature, on ``device``."""
    kind = sig[0]
    if kind == "n":
        return None
    if kind == "t":
        return torch.zeros(sig[1], dtype=getattr(torch, sig[2]), device=device)
    if kind == "a":
        return np.zeros(sig[1], dtype=sig[2])
    if kind == "d":
        return {k: _materialize(v, device) for k, v in sig[1]}
    if kind == "s":
        return tuple(_materialize(v, device) for v in sig[1])
    return sig[1]


def _args_of(key, device):
    args, kwargs = _materialize(key, device)
    return tuple(args), dict(kwargs)


# ---------------------------------------------------------------------------
# Model snapshots: a warm of a training site never trains
# ---------------------------------------------------------------------------

def _clone(tree):
    return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


class _ModelSnapshot:
    """Params (restored in place), updater and layer state, the step
    counters and the generator of ``model``."""

    _COUNTERS = ("iteration", "epoch", "batch_in_epoch")

    def __init__(self, model):
        self.model = model
        self.params = [p.detach().clone() for p in tree_leaves(model.params)]
        self.state = _clone(model.state)
        self.opt_state = _clone(model.opt_state)
        gen = getattr(model, "_gen", None)
        self.gen = gen.get_state() if gen is not None else None
        self.counters = {k: getattr(model, k) for k in self._COUNTERS if hasattr(model, k)}

    def restore(self):
        m = self.model
        with torch.no_grad():
            for p, s in zip(tree_leaves(m.params), self.params):
                p.copy_(s)
        m.state = self.state
        m.opt_state = self.opt_state
        if self.gen is not None:
            m._gen.set_state(self.gen)
        for k, v in self.counters.items():
            setattr(m, k, v)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
        return False


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------

_MISSING = object()


class AotFunction:
    """One dispatch site of a model and its signature table.

    ``fn`` is the site's callable (None for a site whose grid a program
    runs itself, :func:`grid_site`). ``stateful`` sites (training steps)
    are warmed on a snapshot that is restored afterwards. ``replay`` says
    whether a signature restored from a bundle is replayed here with zero
    arguments of its recorded shapes (a program-run grid is not)."""

    def __init__(self, fn: Optional[Callable], site: str, model=None,
                 stateful: bool = False, replay: bool = True):
        self._fn = fn
        self.site = site
        self._model = model
        self.stateful = stateful
        self.replay = replay and fn is not None
        dev = getattr(model, "device", None)
        self._device = torch.device(dev) if dev is not None else None
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._warmed: Dict[Tuple, str] = {}          # key -> cost label
        self._seen: Dict[Tuple, None] = {}           # dispatched, never warmed
        self._pending: Dict[Tuple, Tuple[str, Optional[dict]]] = {}   # from a bundle
        self._lock = threading.Lock()

    # -- dispatch ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        key = signature_key(args, kwargs)
        label = self._warmed.get(key)
        if label is None:
            if key not in self._seen:
                with self._lock:
                    self._seen.setdefault(key, None)
            return self._fn(*args, **kwargs)
        obs.counter("dl4j_aot_warm_hits_total",
                    "dispatches of a warmed (or bundle-restored) signature",
                    ("site",)).inc(site=self.site)
        start = _profile.sample_start(self.site, label) if self._cuda else None
        out = self._fn(*args, **kwargs)
        if start is not None:
            _profile.sample_stop(self.site, label, start)
        return out

    def note_seen(self, *args, **kwargs) -> None:
        """Record a dispatch a program ran itself (a grid site)."""
        key = signature_key(args, kwargs)
        if key not in self._warmed and key not in self._seen:
            with self._lock:
                self._seen.setdefault(key, None)

    # -- warm --------------------------------------------------------------
    def _run(self, args, kwargs):
        if self.stateful:
            with _ModelSnapshot(self._model):
                return self._fn(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def warm(self, *args, cost_key: Optional[str] = None, price: bool = True, **kwargs):
        """Run one dispatch of this exact signature unless it is warm
        already; returns True when it ran. A signature restored from a
        bundle takes the bundle's cost entry; otherwise ``price`` runs the
        dispatch under a counting pass and records its costs under
        ``cost_key`` (default: a signature label)."""
        key = signature_key(args, kwargs)
        if key in self._warmed:
            return False
        with self._lock:
            pend = self._pending.pop(key, _MISSING)
        label = cost_key or (pend[0] if pend is not _MISSING else _sig_label(key))
        mode = "bundle_restore" if pend is not _MISSING else "warm"
        dtype = _dtype_name(getattr(self._model, "dtype", ""))
        with obs.compile_span(self.site, mode=mode):
            if pend is not _MISSING and pend[1] is not None:
                self._run(args, kwargs)
                _profile.record(self.site, label, pend[1])
            elif price:
                _profile.harvest_compiled(self.site, lambda: self._run(args, kwargs),
                                          label, dtype=dtype, device=self._device)
            else:
                self._run(args, kwargs)
        with self._lock:
            self._warmed[key] = label
            self._seen.pop(key, None)
        return True

    def mark_warm(self, *args, cost_key: Optional[str] = None, **kwargs) -> None:
        """Record a signature that a program's own warm pass ran (a grid
        site: decode steps, search tiers)."""
        key = signature_key(args, kwargs)
        with self._lock:
            pend = self._pending.pop(key, None)
            self._warmed.setdefault(key, cost_key or (pend[0] if pend else _sig_label(key)))
            self._seen.pop(key, None)

    def install(self, key: Tuple, label: str, cost: Optional[dict]) -> None:
        """Adopt a signature restored from a bundle. A training site takes
        it as warm at once, without a dispatch (a replay would be a whole
        extra step; the first real step is its own warm-up); an inference
        site keeps it for :meth:`replay_pending`; a grid site until its
        program's warm pass marks it."""
        if cost is not None:
            _profile.record(self.site, label, cost)
        with self._lock:
            if key in self._warmed:
                return
            if self.stateful:
                self._warmed[key] = label
            else:
                self._pending[key] = (label, cost)

    def replay_pending(self) -> int:
        """Warm every restored signature once, from zeros of its shapes."""
        if not self.replay:
            return 0
        n = 0
        for key in list(self._pending):
            args, kwargs = _args_of(key, self._device)
            label = self._pending.get(key, (None,))[0]
            if self.warm(*args, cost_key=label, **kwargs):
                n += 1
        if n and self._cuda:
            torch.cuda.synchronize(self._device)
        return n

    # -- views -------------------------------------------------------------
    @property
    def compiled_count(self) -> int:
        return len(self._warmed)

    def signatures(self) -> List[Tuple]:
        """Warmed signatures, then the ones seen lazily."""
        return list(self._warmed) + [k for k in self._seen if k not in self._warmed]

    def entries(self) -> List[Tuple[Tuple, str, bool]]:
        """(key, cost label, warmed) for every signature of this site."""
        out = [(k, lab, True) for k, lab in self._warmed.items()]
        out += [(k, _sig_label(k), False) for k in self._seen if k not in self._warmed]
        out += [(k, lab, False) for k, (lab, _) in self._pending.items()
                if k not in self._warmed and k not in self._seen]
        return out


def wrap(fn: Optional[Callable], site: str, model=None, stateful: bool = False,
         replay: bool = True) -> AotFunction:
    """Wrap a dispatch site and register it on ``model``'s site table
    (``model._aot_fns``). Signatures restored from a bundle before the site
    existed wait in ``model._aot_pending`` and are adopted here."""
    fn_ = AotFunction(fn, site, model=model, stateful=stateful, replay=replay)
    if model is not None:
        model.__dict__.setdefault("_aot_fns", {})[site] = fn_
        pending = model.__dict__.get("_aot_pending")
        if pending:
            for key, label, cost in pending.pop(site, ()):
                fn_.install(key, label, cost)
    return fn_


def site(model, name: str, fn: Optional[Callable] = None, *, stateful: bool = False,
         replay: bool = True) -> AotFunction:
    """``model``'s site ``name``, wrapping ``fn`` on first use."""
    fns = model.__dict__.get("_aot_fns")
    existing = fns.get(name) if fns else None
    if existing is not None:
        return existing
    return wrap(fn, name, model, stateful=stateful, replay=replay)


def grid_site(model, name: str) -> AotFunction:
    """A site whose dispatch grid a program runs itself (``DecodeProgram``,
    ``SearchProgram``): it records signatures, and a bundle's entries for
    it are marked warm by the program's warm pass."""
    return site(model, name, replay=False)


# ---------------------------------------------------------------------------
# Warmers
# ---------------------------------------------------------------------------

def _is_graph(model) -> bool:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return isinstance(model, ComputationGraph)


def _dummy_features(model, batch: int):
    """The output site's features at ``batch`` rows: the MultiLayerNetwork's
    ``dummy_input`` (int ids for a sequence embedding), a tuple of one per
    input for a graph."""
    if not _is_graph(model):
        return model.dummy_input(batch)
    if len(model.conf.inputs) == 1:
        return (model.dummy_input(batch),)
    return tuple(torch.zeros(model.conf.input_types[n].batch_shape(batch),
                             dtype=model.dtype, device=model.device)
                 for n in model.conf.inputs)


def _sync(model):
    if torch.device(model.device).type == "cuda":
        torch.cuda.synchronize(model.device)


def warm_serving(model, max_batch: int,
                 ladder: Optional[bucketing.BucketLadder] = None) -> int:
    """Run the inference path once for every ladder bucket reachable by
    batches up to ``max_batch`` (priced by a counting pass, cost key
    ``b<bucket>``). Returns the number of warm signatures of the site."""
    if model.params is None:
        model.init()
    is_graph = _is_graph(model)
    if is_graph and model._has_batch_vertices:
        # Stack/Unstack graphs run unbucketed: no finite bucket set
        obs.event("aot_warmup_skipped", site="cg.output", reason="batch_vertices")
        return 0
    buckets = (reachable_buckets(max_batch, ladder)
               if bucketing.bucketing_enabled() else [max_batch])
    fn = model._get_output_fn()
    t0 = time.perf_counter()
    for b in buckets:
        if fn.warm(_dummy_features(model, b), None, cost_key=f"b{b}"):
            # a warm dispatch is a full bucket, as ``output`` records it
            bucketing.telemetry().record_hit(fn.site, b, b)
    _sync(model)
    obs.event("aot_warmup", site=fn.site, buckets=list(buckets),
              executables=fn.compiled_count,
              duration_s=round(time.perf_counter() - t0, 6))
    return fn.compiled_count


def warm_serving_bundled(model, max_batch: int, bundle_path,
                         ladder: Optional[bucketing.BucketLadder] = None
                         ) -> Tuple[int, int]:
    """The serving tier's warm pipeline: restore the signatures persisted
    at ``bundle_path`` (replayed with their recorded costs), warm the
    ladder up to ``max_batch`` (restored buckets are warm already), then
    persist the warm set back. Returns ``(restored, warmed)``."""
    restored = restore_bundle(model, bundle_path) if bundle_path else 0
    warmed = warm_serving(model, max_batch, ladder)
    if bundle_path and warmed:
        save_bundle(model, bundle_path)
    return restored, warmed


def _first_fit_batch(model, data, batch_size):
    """(x, y, fm, lm, pad_target) of the first batch fit() will dispatch,
    or None for a streaming source."""
    from deeplearning4j_tpu_torch.nn import model as M

    source = data() if callable(data) else data
    if hasattr(source, "as_tuple"):
        source = source.as_tuple()
    if not M._is_arrays(source):
        return None
    pad_target = (M._fit_pad_target(source, batch_size)
                  if bucketing.bucketing_enabled() else None)
    x, y, fm, lm = M._as_batch(source)
    b = min(batch_size or len(x), len(x))
    sl = slice(0, b)
    return (x[sl], y[sl] if y is not None else None,
            fm[sl] if fm is not None else None,
            lm[sl] if lm is not None else None, pad_target)


def warm_fit(model, data, batch_size: Optional[int] = None) -> int:
    """Run the training step once, on a snapshot, for the first batch
    shape fit() is about to dispatch (the real leading rows, sliced, never
    consumed: label dtypes decide the signature). Streaming sources return
    0. Params, updater state, layer state and generator end bit-identical.
    With a bundle already restored this is a signature check."""
    from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask

    if _is_graph(model):
        return _warm_fit_graph(model, data, batch_size)
    if model.params is None:
        model.init()
    first = _first_fit_batch(model, data, batch_size)
    if first is None:
        return 0
    x, y, fm, lm, pad_target = first
    ew = None
    if pad_target is not None:
        x, y, fm, lm, ew = bucketing.pad_fit_batch(x, y, fm, lm, pad_target, site="mln.fit")
    dt, dev = model.dtype, model.device
    step = model._get_step_fn()
    before = step.compiled_count
    t0 = time.perf_counter()
    bucket = pad_target if pad_target is not None else len(x)
    step.warm(model._features(x), _cast_labels(y, dt, dev), _cast_mask(fm, dt, dev),
              _cast_mask(lm, dt, dev), _cast_mask(ew, dt, dev), cost_key=f"b{bucket}")
    _sync(model)
    obs.event("aot_warmup", site="mln.step", buckets=[int(bucket)],
              executables=step.compiled_count,
              duration_s=round(time.perf_counter() - t0, 6))
    return step.compiled_count - before


def _warm_fit_graph(model, data, batch_size: Optional[int]) -> int:
    from deeplearning4j_tpu_torch.nn.model import _cast_mask

    if model.params is None:
        model.init()
    source = data() if callable(data) else data
    if hasattr(source, "as_tuple"):
        source = source.as_tuple()
    if not model._is_single_multibatch(source):
        return 0
    pad_target = (model._fit_pad_target_multi(source, batch_size)
                  if bucketing.bucketing_enabled() else None)
    f, l, fm, lm = model._as_multi_batch(source)
    b = min(batch_size or len(f[0]), len(f[0]))
    cut = lambda t: (tuple(a[:b] if a is not None else None for a in t)  # noqa: E731
                     if t is not None else None)
    f, l, fm, lm = cut(f), cut(l), cut(fm), cut(lm)
    ew = None
    if pad_target is not None:
        f, l, fm, lm, ew = bucketing.pad_fit_multi(f, l, fm, lm, pad_target, site="cg.fit")
    step = model._get_step_fn()
    before = step.compiled_count
    t0 = time.perf_counter()
    bucket = pad_target if pad_target is not None else b
    inputs, labels, fms, lms = model._to_device(f, l, fm, lm)
    step.warm(inputs, labels, fms, lms, _cast_mask(ew, model.dtype, model.device),
              cost_key=f"b{bucket}")
    _sync(model)
    obs.event("aot_warmup", site="cg.step", buckets=[int(bucket)],
              executables=step.compiled_count,
              duration_s=round(time.perf_counter() - t0, 6))
    return step.compiled_count - before


def warm_dp(runner, x, y, fm=None, lm=None, ew=None) -> int:
    """Run a data-parallel step (``parallel/grads.py`` DataParallelStep)
    once for this rank's batch shape, entering the exchange layout if
    needed, on a snapshot of the model and of the runner's updater slices
    and residuals, all restored afterwards. A collective: every rank calls
    it with its own rows. Returns 1 when the signature was new."""
    if not runner.active:
        runner.begin()
    model = runner.model
    if runner.is_graph:
        call = lambda f, l, fm_, lm_, ew_: runner.fit_batch_graph((f, l, fm_, lm_), ew=ew_)  # noqa: E731
    else:
        call = runner.fit_batch
    site_fn = runner.__dict__.get("_aot_site")
    if site_fn is None:   # the site is the runner's: another runner, another step
        site_fn = runner._aot_site = wrap(call, "dp.step", model, stateful=True, replay=False)
    before = site_fn.compiled_count
    t0 = time.perf_counter()
    saved = (_clone(runner._opt_flat), _clone(runner._residual))
    try:
        site_fn.warm(x, y, fm, lm, ew,
                     cost_key=f"b{len(x[0] if runner.is_graph else x)}")
    finally:
        runner._opt_flat, runner._residual = saved
    _sync(model)
    obs.event("aot_warmup", site="dp.step", executables=site_fn.compiled_count,
              duration_s=round(time.perf_counter() - t0, 6))
    return site_fn.compiled_count - before


# ---------------------------------------------------------------------------
# Identity, fingerprint, gate
# ---------------------------------------------------------------------------

def model_signature(model) -> str:
    """Identity of the model a bundle or a tuning-DB entry belongs to:
    sha256 over the class name, the dtype's name and the config JSON
    without ``seed`` — the JAX package's hash for the same configuration,
    so both packages name one model alike."""
    conf = json.loads(model.conf.to_json())
    conf.pop("seed", None)
    h = hashlib.sha256()
    h.update(type(model).__name__.encode())
    h.update(_dtype_name(model.dtype).encode())
    h.update(json.dumps(conf, sort_keys=True).encode())
    return h.hexdigest()


def bundle_path_for(checkpoint_path) -> str:
    """Sidecar path of the bundle shipped with a checkpoint (a cache, not
    state: losing it costs a warm, nothing else)."""
    return os.fspath(checkpoint_path) + ".aotbundle"


def _backend(model=None) -> str:
    dev = getattr(model, "device", None) if model is not None else None
    if dev is not None:
        return "cuda" if torch.device(dev).type == "cuda" else "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def toolchain_fingerprint(backend: Optional[str] = None) -> dict:
    """What decides whether a persisted artifact (a bundle's costs, a
    tuning-DB winner) still holds: torch and CUDA versions, the card and
    the backend (``cuda`` or ``cpu``)."""
    backend = backend or _backend()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": (torch.cuda.get_device_name(torch.cuda.current_device())
                        if backend == "cuda" else "cpu"),
        "backend": backend,
    }


_validated: Dict[str, bool] = {}
_validated_lock = threading.Lock()


def reset_validation() -> None:
    with _validated_lock:
        _validated.clear()


def _selftest(backend: str) -> dict:
    """Round trip of a tiny network's warm set through a bundle on
    ``backend``: the restored model must hold the same signatures and
    answer every warmed bucket with the original's bits."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

    device = "cuda" if backend == "cuda" else "cpu"
    conf = MultiLayerConfiguration(
        layers=(L.Dense(n_out=16, activation="tanh"),
                L.OutputLayer(n_out=4, activation="softmax")),
        input_type=InputType.feed_forward(8), seed=7)
    a = MultiLayerNetwork(conf, device=device).init()
    fn = a._get_output_fn()
    for b in reachable_buckets(4):   # unpriced: no counting pass
        fn.warm(_dummy_features(a, b), None, cost_key=f"b{b}", price=False)
    out = {"backend": backend, "ok": False}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "selftest.aotbundle")
        info = _write_bundle(a, path)
        b = MultiLayerNetwork(conf, device=device).init()
        n = _read_bundle(b, path)
        x = torch.linspace(-1, 1, 4 * 8, device=device).reshape(4, 8)
        same = all(torch.equal(a.output(x[:k]), b.output(x[:k])) for k in (1, 2, 3, 4))
        sigs = sorted(map(json.dumps, a._get_output_fn().signatures()))
        out.update(entries=(info or {}).get("entries", 0), restored=n, outputs_equal=same,
                   signatures_equal=sigs == sorted(map(json.dumps,
                                                       b._get_output_fn().signatures())))
    out["ok"] = bool(out["restored"] and out["outputs_equal"] and out["signatures_equal"])
    return out


def validate_persistence(backend: Optional[str] = None, timeout_s: float = 120.0) -> bool:
    """Run :func:`_selftest` once per backend in this process (cached): a
    warm from a restored manifest must dispatch the same signatures. Any
    failure disables bundles on that backend. ``timeout_s`` is kept for the
    JAX package's signature (its harness runs in a subprocess; nothing
    here deserializes code)."""
    backend = backend or _backend()
    with _validated_lock:
        if backend in _validated:
            return _validated[backend]
    try:
        with obs.compile_span("aot.validate", backend=backend):
            detail = _selftest(backend)
        ok = bool(detail.get("ok"))
    except Exception as e:
        detail, ok = {"error": repr(e)}, False
    with _validated_lock:
        _validated[backend] = ok
    obs.event("aot_validation", backend=backend, ok=ok, detail=json.dumps(detail))
    return ok


def persistence_allowed(backend: Optional[str] = None) -> bool:
    """May bundles be written and read on this backend:
    ``DL4J_TPU_AOT_BUNDLE=0`` never, ``1`` if :func:`validate_persistence`
    passes, ``auto`` (default) for CUDA and never on the CPU. ``auto`` runs
    no self-test: the JAX package's re-validates executables that XLA
    deserializes, and a bundle here holds JSON and no code."""
    mode = os.environ.get("DL4J_TPU_AOT_BUNDLE", "auto")
    if mode == "0":
        return False
    backend = backend or _backend()
    if mode == "1":
        return validate_persistence(backend)
    return backend == "cuda"


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------

def _manifest(model, entries) -> dict:
    return {
        "format_version": BUNDLE_FORMAT_VERSION,
        **toolchain_fingerprint(_backend(model)),
        "model_signature": None if model is None else model_signature(model),
        "entries": entries,
    }


def _write_bundle(model, path) -> Optional[dict]:
    from deeplearning4j_tpu_torch.utils import serialization

    reg = model.__dict__.get("_aot_fns") or {}
    entries: List[dict] = []
    blobs: List[bytes] = []
    for site_name, fn in sorted(reg.items()):
        for key, label, warmed in fn.entries():
            blob = json.dumps({
                "site": site_name, "key": key, "label": label, "warmed": warmed,
                "cost": _profile.entry_for(site_name, label) if warmed else None,
            }, sort_keys=True).encode()
            name = f"sig/{len(blobs):04d}.json"
            entries.append({"name": name, "site": site_name,
                            "crc32": zlib.crc32(blob) & 0xFFFFFFFF, "size": len(blob)})
            blobs.append(blob)
    if not blobs:
        return None
    manifest = _manifest(model, entries)

    def write_entries(zf):
        zf.writestr(_MANIFEST_ENTRY, json.dumps(manifest, indent=2))
        for meta, blob in zip(entries, blobs):
            zf.writestr(meta["name"], blob)

    serialization._atomic_write_zip(path, write_entries)
    total = os.path.getsize(path)
    obs.counter("dl4j_aot_bundle_saved_total", "warm-set bundles written").inc()
    obs.event("aot_bundle_saved", path=str(path), entries=len(blobs), bytes=total,
              backend=manifest["backend"])
    return {"path": str(path), "entries": len(blobs), "bytes": total}


def save_bundle(model, path) -> Optional[dict]:
    """Write ``model``'s site table (every warmed and seen signature, with
    its cost entry) as a CRC'd zip (atomic write). Returns ``{"path",
    "entries", "bytes"}`` or None when bundles are gated off or nothing is
    recorded. Never raises: a checkpoint must not fail over its sidecar."""
    try:
        if not persistence_allowed(_backend(model)):
            return None
        return _write_bundle(model, path)
    except Exception as e:
        obs.event("aot_bundle_save_failed", path=str(path), error=repr(e))
        return None


def _reject(path, reason: str, **fields) -> int:
    obs.counter("dl4j_aot_bundle_rejected_total",
                "bundles rejected (corrupt, version or backend mismatch): the "
                "model was warmed from the ladder instead", ("reason",)).inc(reason=reason)
    obs.event("aot_bundle_rejected", path=str(path), reason=reason, **fields)
    return 0


def _read_bundle(model, path) -> int:
    backend = _backend(model)
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read(_MANIFEST_ENTRY))
        if manifest.get("format_version") != BUNDLE_FORMAT_VERSION:
            return _reject(path, "format_version", found=manifest.get("format_version"))
        tc = toolchain_fingerprint(backend)
        if (manifest.get("torch_version") != tc["torch_version"]
                or manifest.get("cuda_version") != tc["cuda_version"]):
            return _reject(path, "version_mismatch",
                           bundle_torch=str(manifest.get("torch_version")),
                           bundle_jax=str(manifest.get("jax_version")))
        if manifest.get("backend") != backend:
            return _reject(path, "backend_mismatch",
                           bundle_backend=str(manifest.get("backend")), backend=backend)
        if manifest.get("device_name") != tc["device_name"]:
            return _reject(path, "device_mismatch",
                           bundle_device=str(manifest.get("device_name")))
        if manifest.get("model_signature") != model_signature(model):
            return _reject(path, "model_signature")
        recs = []
        for meta in manifest.get("entries", []):
            blob = zf.read(meta["name"])
            if (zlib.crc32(blob) & 0xFFFFFFFF) != meta.get("crc32"):
                return _reject(path, "crc_mismatch", entry=meta["name"])
            recs.append(json.loads(blob.decode("utf-8")))
    reg = model.__dict__.setdefault("_aot_fns", {})
    pending = model.__dict__.setdefault("_aot_pending", {})
    for rec in recs:
        key = _freeze(rec["key"])
        fn = reg.get(rec["site"])
        if fn is not None:
            fn.install(key, rec["label"], rec.get("cost"))
        else:
            pending.setdefault(rec["site"], []).append((key, rec["label"], rec.get("cost")))
    _attach_standard_fns(model)
    replayed = sum(fn.replay_pending() for fn in list(reg.values()))
    obs.counter("dl4j_aot_bundle_restored_total", "warm-set bundles restored").inc()
    obs.event("aot_bundle_restored", path=str(path), entries=len(recs), replayed=replayed)
    return len(recs)


def restore_bundle(model, path) -> int:
    """Install a bundle's signatures on ``model``'s sites with their
    recorded costs and replay the inference ones (each once, from zeros of
    its recorded shapes; :meth:`AotFunction.install` says what each kind of
    site does). Gated like writes; a format, version,
    backend, device or model-signature mismatch, a CRC failure or any read
    error rejects the whole bundle (counter + event, never an exception).
    Reads JSON only. Returns the number of signatures installed; sites not
    built yet keep theirs in ``model._aot_pending`` until :func:`wrap`."""
    try:
        if not os.path.exists(path):
            return 0
        if not persistence_allowed(_backend(model)):
            return _reject(path, "persistence_disabled")
        return _read_bundle(model, path)
    except Exception as e:
        return _reject(path, "load_error", error=repr(e))


def _attach_standard_fns(model) -> None:
    """Build the standard sites that restored signatures wait for."""
    pending = model.__dict__.get("_aot_pending") or {}
    prefix = "cg" if _is_graph(model) else "mln"
    if f"{prefix}.step" in pending:
        model._get_step_fn()
    if f"{prefix}.step.tbptt" in pending:
        model._get_tbptt_fn()
    if f"{prefix}.output" in pending:
        model._get_output_fn()


# ---------------------------------------------------------------------------
# Distributed bundles (elastic checkpoint layout)
# ---------------------------------------------------------------------------

def distributed_bundle_path(base, rank: int) -> str:
    """This rank's bundle under the elastic checkpoint layout:
    ``<base>_r<rank>.aotbundle``."""
    return f"{os.fspath(base)}_r{int(rank)}.aotbundle"


def _distributed_sidecar(base, rank: int) -> str:
    return f"{os.fspath(base)}_r{int(rank)}.aotmanifest.json"


def _file_crc32(path) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def save_distributed_bundle(model, base, rank: int) -> Optional[dict]:
    """Write this rank's bundle and a CRC'd sidecar manifest entry. The
    replicated model's signatures are the same on every data-parallel rank,
    so any rank's bundle can warm any other. Gated and non-raising like
    :func:`save_bundle`."""
    path = distributed_bundle_path(base, rank)
    info = save_bundle(model, path)
    if info is None:
        return None
    try:
        entry = {"rank": int(rank), "file": os.path.basename(path),
                 "crc32": _file_crc32(path), "size": os.path.getsize(path),
                 "model_signature": model_signature(model),
                 **toolchain_fingerprint(_backend(model))}
        tmp = f"{_distributed_sidecar(base, rank)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=1)
        os.replace(tmp, _distributed_sidecar(base, rank))
        info["manifest"] = entry
    except Exception as e:
        obs.event("aot_bundle_save_failed", path=str(path), error=repr(e))
    return info


def distributed_bundle_manifest(base) -> Dict[int, dict]:
    """The per-rank sidecars of ``base`` as ``{rank: entry}``; unreadable
    ones are dropped (their bundles fail the CRC check anyway)."""
    out: Dict[int, dict] = {}
    for p in sorted(_glob.glob(f"{os.fspath(base)}_r*.aotmanifest.json")):
        try:
            with open(p, "r") as f:
                entry = json.load(f)
            out[int(entry["rank"])] = entry
        except (OSError, ValueError, KeyError):
            continue
    return out


def restore_distributed_bundle(model, base, rank: int) -> int:
    """Restore from the distributed layout: this rank's bundle first, then
    any other rank's CRC-valid one. Returns the signatures installed; 0
    when nothing is usable (never raises)."""
    manifest = distributed_bundle_manifest(base)
    for t in [rank] + sorted(t for t in manifest if t != rank):
        path = distributed_bundle_path(base, t)
        if not os.path.exists(path):
            continue
        entry = manifest.get(t)
        if entry is not None:
            try:
                if (_file_crc32(path) != entry.get("crc32")
                        or os.path.getsize(path) != entry.get("size")):
                    _reject(path, "crc_mismatch", rank=t)
                    continue
            except OSError:
                continue
        n = restore_bundle(model, path)
        if n > 0:
            if t != rank:
                obs.event("aot_bundle_served_by_peer", rank=rank, served_by=t,
                          path=str(path))
            return n
    return 0


# ---------------------------------------------------------------------------
# python -m deeplearning4j_tpu_torch.nn.aot [--device cpu]
# ---------------------------------------------------------------------------

def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.nn.aot",
        description="Print the toolchain fingerprint and run the bundle "
                    "self-test (a tiny network's warm set through a bundle).")
    ap.add_argument("--device", default=None,
                    help="cpu, or the GPU when omitted (raises without one)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device; pass --device cpu"}))
        return 2
    backend = "cpu" if args.device == "cpu" else "cuda"
    result = {"fingerprint": toolchain_fingerprint(backend), **_selftest(backend)}
    sys.stdout.write(json.dumps(result) + "\n")
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(_main())
