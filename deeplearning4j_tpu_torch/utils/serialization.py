"""Model checkpointing: the JAX package's zip format (PyTorch port of
``utils/serialization.py``).

One zip holds ``configuration.json`` (the MultiLayerConfiguration or
ComputationGraphConfiguration JSON), ``coefficients.npz`` (params),
``state.npz`` (layer state),
``updaterState.npz`` (optimizer state) and ``meta.json`` (iteration,
epoch), plus optional ``normalizer.json``. Each npz holds the tree's leaves
as ``leaf_0``, ``leaf_1``, ... in JAX treedef order — dict keys sorted at
every level (``utils/tree.py``) — so a zip written by either package
restores in the other. A ComputationGraph's trees are dicts keyed by
vertex name, so its leaves follow the sorted names (``s2b10_*`` before
``s2b2_*``), never the insertion or topological order. Path targets are written atomically: a tmp file in
the destination directory, fsync, ``os.replace``, directory fsync.

bf16 leaves: the JAX package writes ``ml_dtypes.bfloat16`` arrays, which
npz stores as raw 2-byte ``<V2`` records. The port reads any 2-byte void
leaf as bf16 bits and writes its bf16 leaves in that same layout, header
included, without needing ``ml_dtypes``.

Full-state checkpoints (train/resilience.py) add ``trainState.json``: the
batch position in the epoch, the LR scale, a telemetry snapshot and the
model generator's state. The port writes that state under
``"torch_rng"`` (its bytes) and ``"torch_rng_device"``, never under
``"rng"``, which the JAX package reads as its JAX PRNG key; each package
restores the other's batch position and LR scale, and neither can take the
other's random stream (the port warns once when a model that draws
randomness loads a JAX key). ``residuals.npz`` holds the compressed
data-parallel exchange's error-feedback residuals (``parallel/grads.py``),
one ``[R, n_pad]`` float32 array per exchanged layer keyed by its index or
vertex name, in both packages; a restore parks them on the model for the
exchange to take up.

Leaves on the card are copied to the host as raw bytes through one
page-locked buffer, bf16 as its bits (``serve/scheduler.py`` ``_to_host``
does the same for outputs), and every entry is stored, not deflated.

No pickle anywhere: configs are JSON, tensors are npz.
"""

from __future__ import annotations

import io
import json
import os
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

__all__ = ["apply_snapshot", "read_snapshot", "restore_network",
           "restore_normalizer", "save_network"]

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
STATE_ENTRY = "state.npz"
UPDATER_ENTRY = "updaterState.npz"
META_ENTRY = "meta.json"
NORMALIZER_ENTRY = "normalizer.json"
RESIDUALS_ENTRY = "residuals.npz"
TRAIN_STATE_ENTRY = "trainState.json"
# npz entries are stored, not deflated: float leaves barely compress, and
# deflating the gigabytes of a large model's params and Adam moments takes
# minutes (either package reads both methods)
_STORED = zipfile.ZIP_STORED


class _HostStage:
    """One host buffer that every leaf on the card passes through on its way
    to the file, page-locked when a card is present and grown to the
    largest leaf."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def bytes_of(self, t: torch.Tensor) -> memoryview:
        raw = t.reshape(-1).view(torch.uint8)
        if t.device.type == "cpu":
            return memoryview(raw.numpy())
        n = raw.numel()
        if self._buf is None or self._buf.numel() < n:
            self._buf = torch.empty(n, dtype=torch.uint8,
                                    pin_memory=torch.cuda.is_available())
        host = self._buf[:n]
        host.copy_(raw)
        return memoryview(host.numpy())


def _write_npy(f, t: torch.Tensor, stage: _HostStage) -> None:
    """One leaf as .npy: the header, then the raw bytes; bf16 under the
    ``<V2`` descr that numpy gives ``ml_dtypes.bfloat16``."""
    t = t.detach().contiguous()
    descr = "<V2" if t.dtype == torch.bfloat16 else np.dtype(
        str(t.dtype).replace("torch.", "")).str
    hdr = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        hdr, {"descr": descr, "fortran_order": False, "shape": tuple(t.shape)})
    f.write(hdr.getvalue())
    if t.numel():
        f.write(stage.bytes_of(t))


def _tree_to_npz_bytes(tree, stage: Optional[_HostStage] = None) -> bytes:
    """``np.savez``'s layout (stored, not deflated) over the tree's leaves."""
    stage = stage or _HostStage()
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, leaf in enumerate(tree_leaves(tree)):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                _write_npy(f, leaf, stage)
    return buf.getvalue()


def _npz_bytes_to_leaves(data: bytes):
    with np.load(io.BytesIO(data)) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def _leaf_tensor(a: np.ndarray) -> torch.Tensor:
    """A stored leaf as a CPU tensor; 2-byte void records are bf16 bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _restore_tree_like(template, leaves):
    flat = tree_leaves(template)
    if len(flat) != len(leaves):
        raise ValueError(
            f"Checkpoint has {len(leaves)} arrays but model expects {len(flat)} — "
            "config/checkpoint mismatch")
    return tree_unflatten_like(template, [
        _leaf_tensor(l).to(device=f.device, dtype=f.dtype).reshape(f.shape)
        for l, f in zip(leaves, flat)])


def _atomic_write_zip(path, write_entries) -> None:
    """Write a zip durably: tmp in the same directory, fsync the file, swap
    it in with ``os.replace``, then fsync the directory."""
    target = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(target))
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", _STORED, allowZip64=True) as zf:
            write_entries(zf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    dfd = os.open(directory or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_network(model, path, save_updater: bool = True,
                 normalizer: Optional[dict] = None,
                 train_state: Optional[dict] = None,
                 residuals: Optional[dict] = None, opt_state=None):
    """Write a MultiLayerNetwork or a ComputationGraph to a zip (a path,
    written atomically, or a writable file object). ``updaterState.npz`` is written once the model
    has optimizer state; a reader of a zip without it starts from a fresh
    updater state, which is what an untrained model's would be.
    ``train_state`` adds ``trainState.json`` (see train/resilience.py),
    ``residuals`` the exchange's ``residuals.npz``; ``opt_state`` replaces
    the model's optimizer state (the exchange's snapshot mid-fit)."""
    meta = {
        "framework": "deeplearning4j_tpu_torch",
        "format_version": 1,
        "iteration": model.iteration,
        "epoch": getattr(model, "epoch", 0),
        "model_class": type(model).__name__,
    }
    stage = _HostStage()

    def write_entries(zf):
        zf.writestr(CONFIG_ENTRY, model.conf.to_json(indent=2))
        zf.writestr(COEFFICIENTS_ENTRY, _tree_to_npz_bytes(model.params, stage))
        zf.writestr(STATE_ENTRY, _tree_to_npz_bytes(model.state, stage))
        opt = opt_state if opt_state is not None else model.opt_state
        if save_updater and opt is not None:
            zf.writestr(UPDATER_ENTRY, _tree_to_npz_bytes(opt, stage))
        if residuals is not None:
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v) for k, v in residuals.items()})
            zf.writestr(RESIDUALS_ENTRY, buf.getvalue())
        if normalizer is not None:
            zf.writestr(NORMALIZER_ENTRY, json.dumps(normalizer))
        if train_state is not None:
            zf.writestr(TRAIN_STATE_ENTRY, json.dumps(train_state))
        zf.writestr(META_ENTRY, json.dumps(meta))

    if isinstance(path, (str, os.PathLike)):
        _atomic_write_zip(path, write_entries)
    else:
        # graftlint: disable=durable-store-protocol; a caller's stream; paths take _atomic_write_zip
        with zipfile.ZipFile(path, "w", _STORED, allowZip64=True) as zf:
            write_entries(zf)
    return path


def read_snapshot(path, load_updater: bool = True) -> dict:
    """Every entry the port reads, as plain host data: the config dict, meta,
    the leaf lists and the train state (None when absent)."""
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())

        def leaves(entry, wanted=True):
            return _npz_bytes_to_leaves(zf.read(entry)) if wanted and entry in names else None

        return {
            "conf": json.loads(zf.read(CONFIG_ENTRY)),
            "meta": json.loads(zf.read(META_ENTRY)) if META_ENTRY in names else {},
            "coeff": leaves(COEFFICIENTS_ENTRY),
            "state": leaves(STATE_ENTRY),
            "upd": leaves(UPDATER_ENTRY, load_updater),
            "train_state": (json.loads(zf.read(TRAIN_STATE_ENTRY))
                            if TRAIN_STATE_ENTRY in names else None),
            "residuals": (_npz_dict(zf.read(RESIDUALS_ENTRY))
                          if RESIDUALS_ENTRY in names else None),
        }


def _npz_dict(raw: bytes) -> dict:
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


def apply_snapshot(model, snap: dict, load_updater: bool = True):
    """Apply a :func:`read_snapshot` result onto an initialized model:
    params, state, optimizer state, iteration and epoch, and the train
    state when the zip holds one."""
    model.params = _restore_tree_like(model.params, snap["coeff"])
    if snap["state"] is not None:
        model.state = _restore_tree_like(model.state, snap["state"])
    if load_updater and snap["upd"] is not None:
        model.opt_state = _restore_tree_like(model.init_opt_state(), snap["upd"])
    meta = snap["meta"]
    model.iteration = meta.get("iteration", 0)
    model.epoch = meta.get("epoch", 0)
    if snap.get("train_state"):
        _apply_train_state(model, snap["train_state"])
    # the data-parallel exchange takes these up when it (re)starts
    model._pending_residuals = snap.get("residuals")
    return model


_JAX_KEY_WARNED = False


def _apply_train_state(model, ts: dict) -> None:
    """The batch position, the LR scale (the updaters are rebuilt when it
    changes) and, from a port zip written on the same kind of device, the
    generator's state."""
    global _JAX_KEY_WARNED
    gen = getattr(model, "_gen", None)
    rng = ts.get("torch_rng")
    if rng is not None and gen is not None:
        if ts.get("torch_rng_device") == gen.device.type:
            gen.set_state(torch.tensor(rng, dtype=torch.uint8))
        else:
            warnings.warn(
                f"trainState.json holds a {ts.get('torch_rng_device')} generator "
                f"state and the model's generator is on {gen.device.type}: the "
                "random stream is not restored")
    elif ts.get("rng") is not None and not _JAX_KEY_WARNED and getattr(
            model, "uses_rng", lambda: False)():
        _JAX_KEY_WARNED = True
        warnings.warn(
            "trainState.json holds a JAX PRNG key, which a torch.Generator "
            "cannot take: the model's random stream (dropout, noise) is not "
            "restored; everything else is")
    model.batch_in_epoch = int(ts.get("batch_in_epoch", 0))
    scale = float(ts.get("lr_scale", 1.0))
    prev = float(getattr(model, "_lr_scale", 1.0))
    model._lr_scale = scale
    if scale != prev and hasattr(model, "_build_updaters"):
        model._build_updaters()


def restore_network(path, load_updater: bool = True, device=None):
    """Restore a model saved by either package's ``save_network`` onto
    ``device`` (the GPU unless named): a ComputationGraph or a
    MultiLayerNetwork, as the configuration's ``"format"`` tag says."""
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

    snap = read_snapshot(path, load_updater=load_updater)
    if snap["conf"].get("format", "").endswith("ComputationGraphConfiguration"):
        model = ComputationGraph(ComputationGraphConfiguration.from_dict(snap["conf"]),
                                 device=device).init()
    else:
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(snap["conf"]),
                                  device=device).init()
    return apply_snapshot(model, snap, load_updater=load_updater)


def restore_normalizer(path) -> Optional[dict]:
    with zipfile.ZipFile(path, "r") as zf:
        if NORMALIZER_ENTRY in zf.namelist():
            return json.loads(zf.read(NORMALIZER_ENTRY))
    return None
