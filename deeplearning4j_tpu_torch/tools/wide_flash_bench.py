"""Time the wide-head flash kernels (head dims past 256) on the card for the
port found under ``--root``.

    python3 deeplearning4j_tpu_torch/tools/wide_flash_bench.py [--root DIR] [--lm] [--variants]

``--root`` is the directory holding the ``deeplearning4j_tpu_torch``
package to measure (default: this checkout), so one copy of the script
times two checkouts, each in its own process; run them interleaved (A, B,
B, A) in one call on one card to compare them. Prints one JSON line:

- ``kernels``: the forward, dq and dk/dv through the port's wrappers
  (``flash_fwd_cuda``, ``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda``),
  causal, and the whole backward (delta, dq and dk/dv: ``flash_bwd_cuda``),
  by CUDA events, at B16 T2048 H4 D512 (the products of kernel
  #1's flagship shape, B16 T2048 H16 D128) in bf16 and f32, B2 T512 H4 at
  D 320 and 512 in bf16 and f32, and B1 T256 H2 at D 3072 (column groups)
  in bf16, each beside its bounds (bf16 at 989 TFLOP/s, f32 at 67 of FMA)
  and ``scaled_dot_product_attention``'s forward and backward, with the
  backend SDPA picked;
- with ``--variants`` (a checkout with ``wide_plan``), at B16 T2048 H4
  D512: the 16-bit forward with Q streamed and dk/dv with K and V
  streamed beside resident (the streamed plans are built here from
  ``wide_plan``'s), the f32 forward in 256-column groups beside its
  512-column one, and builds of patched copies of the source
  (``_SOURCE_VARIANTS``): dk/dv with its producer skipping the score
  steps' Q and dO boxes, or every Q and dO box (what the box stream costs
  it), the f32 forward without its copies, its score FMAs or its P.V
  (what each part costs), and the f32 dq with a ring of 3 or 4 slots,
  the f32 dq and dk/dv with 2 (batch, head) pairs a head group, their
  score loop not unrolled, dk/dv's chunk loop unrolled or one chunk a
  score item (the design choices);
- with ``--lm``: the flagship TransformerLM of ``bench.py:546`` with 4
  heads (D = 512: vocab 2048, T 2048, d_model 2048, 8 blocks, bf16, seed
  12345, Adam 1e-4): one 16 x 2048 ``output`` dispatch (ms, CUDA events,
  after a warm one), then a warm training step and 3 timed ones
  (``_fit_batch``, CUDA events) at 16 x 2048 with one step split into
  forward / backward / update, the loss of each, the launches of each
  flash kernel a dispatch and a step, and the peak memory; then the same
  for the same configuration in float32 (under ``float32``).

The card's name and power limit go with the line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys

PEAK = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _bounds(B, T, H, D, dtype):
    """Forward, dq and dk/dv bounds (ms) at a causal shape: their products
    over the kept pairs (2, 3 and 4 of 2 B H pairs D flops) at the dtype's
    peak, against q, k, v, out (and do, lse, delta and the gradients) moved
    once."""
    pairs = T * (T + 1) // 2
    prod = 2.0 * B * H * pairs * D
    es = 4 if dtype == "float32" else 2
    peak = PEAK[dtype]
    fwd = max(2 * prod / peak, (4 * B * T * H * D * es + 4 * B * H * T) / PEAK_BYTES)
    dq = max(3 * prod / peak, (5 * B * T * H * D * es + 8 * B * H * T) / PEAK_BYTES)
    dkv = max(4 * prod / peak, (6 * B * T * H * D * es + 8 * B * H * T) / PEAK_BYTES)
    return fwd * 1e3, dq * 1e3, dkv * 1e3


def _sdpa_backend(torch, q, k, v) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    code = int(torch._fused_sdp_choice(q, k, v, is_causal=True))
    return {m.value: n for n, m in SDPBackend.__members__.items()}.get(code, str(code))


def _kernels(torch, fa, variants: bool) -> dict:
    def time_ms(fn, iters, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = []
    bf16, f32 = "bfloat16", "float32"
    shapes = ((16, 2048, 4, 512, bf16, 5), (16, 2048, 4, 512, f32, 3),
              (2, 512, 4, 320, bf16, 20), (2, 512, 4, 512, bf16, 20),
              (2, 512, 4, 320, f32, 20), (2, 512, 4, 512, f32, 20),
              (1, 256, 2, 3072, bf16, 10))
    for B, T, H, D, dtype, iters in shapes:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(D)
        qkv = torch.randn(B, T, 3 * H, D, generator=g, device="cuda").to(dt)
        q, k, v = qkv.split(H, dim=2)   # the fused-qkv views the attention layer passes
        o, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
        do = torch.randn(B, T, H, D, generator=g, device="cuda").to(dt)
        delta = fa._delta(o, do)
        row = {"shape": [B, T, H, D], "dtype": dtype, "causal": True,
               "fwd_ms": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal=True), iters),
               "dkv_ms": time_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None,
                                                               True), iters),
               "dq_ms": time_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None,
                                                             True), max(1, iters // 4), 1),
               # the whole backward: delta, dq and dk/dv (flash_bwd_cuda)
               "bwd_ms": time_ms(lambda: fa.flash_bwd_cuda(q, k, v, o, lse, do, None, True),
                                 max(1, iters // 2), 1)}
        row["fwd_bound_ms"], row["dq_bound_ms"], row["dkv_bound_ms"] = _bounds(B, T, H, D, dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["sdpa_fwd_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        og = sdpa(qg, kg, vg, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                                                 retain_graph=True), iters)
        row["sdpa_backend"] = {"fwd": _sdpa_backend(torch, qt, kt, vt),
                               "fwd_bwd": _sdpa_backend(torch, qg, kg, vg)}
        if hasattr(fa, "wide_plan"):
            row["routes"] = {kern: fa.wide_plan(kern, D, dt).route for kern in fa.WIDE_KERNELS}
        if variants and (B, T, H, D) == (16, 2048, 4, 512) and hasattr(fa, "wide_plan"):
            run = {"fwd": lambda: fa.flash_fwd_cuda(q, k, v, causal=True),
                   "dq": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, True),
                   "dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True)}
            plan = fa.wide_plan
            try:
                if dtype == bf16:
                    fa.wide_plan = lambda kern, d, t: _streamed(fa, plan(kern, d, t))
                    for kern, what in (("fwd", "q"), ("dkv", "kv")):
                        row[f"{kern}_{what}_streamed_ms"] = time_ms(run[kern], iters)
                    row["streamed_plans"] = {kern: str(fa.wide_plan(kern, D, dt))
                                             for kern in ("fwd", "dkv")}
                else:   # the f32 forward in 256-column groups (the scores twice)
                    fa.wide_plan = lambda kern, d, t: _halved(plan(kern, d, t))
                    row["fwd_256_column_groups_ms"] = time_ms(run["fwd"], iters)
                for label, (kern, kdtype, _, _, *slots) in _SOURCE_VARIANTS.items():
                    if kdtype == dtype:
                        # a variant's ring depth goes into the plan it is launched with
                        fa.wide_plan = lambda k, d, t, kern=kern, slots=slots: (
                            dataclasses.replace(plan(k, d, t), slots=slots[0])
                            if slots and k == kern else plan(k, d, t))
                        with _variant_source(fa, label):
                            row[f"{label}_ms"] = time_ms(run[kern], iters)
            finally:
                fa.wide_plan = plan
        out.append(row)
        del q, k, v, qkv, o, lse, do, delta, qt, kt, vt, qg, kg, vg, og, dot
        torch.cuda.empty_cache()
    return out


# Variants built from a patched copy of flash_wide.cu (timing only: their
# results are not attention), each edit made inside one function: the
# kernel to time, its dtype, the function's first line and the edits.
# dk/dv loading fewer of the boxes the producer streams through the ring
# (the producer arrives on a skipped box's barrier without loading it, so
# the consumers run the same products and exchanges on whatever the slot
# held): "no_score_loads" skips the score steps' Q and dO boxes (all of D),
# "no_loads" also the group's boxes of the accumulation steps. The f32
# forward without its cp.async copies, without the score FMAs, or without
# P.V: what each part of it costs.
_SCORE_PUTS = ("ring.put(pos, &p.q, c * BOX, h, q0, b);",
               "ring.put(pos, &p.o, c * BOX, h, q0, b);")
_GROUP_PUTS = ("ring.put(pos, &p.q, (gb + j) * BOX, h, q0, b);",
               "ring.put(pos, &p.o, (gb + j) * BOX, h, q0, b);")
_DKV = "flash_wide_dkv_wgmma_kernel(__grid_constant__"
_TILES = "flash_wide_fwd_tiles_kernel(const Params p)"
# the f32 dq and dk/dv with 2 (batch, head) pairs a head group in their
# block order instead of block_coords' 8 (what L2 holds of K and V, or Q
# and dO: 16 MB of f32 at D = 512 against 64)
_DQ_TILES = "flash_wide_dq_tiles_kernel(const Params p)"
_SCORES_UNROLL = ("#pragma unroll 2\n  for (int d = d0;", "#pragma unroll 1\n  for (int d = d0;")
_DKV_TILES = "flash_wide_dkv_tiles_kernel(const Params p)"
_TILES_SLOTS = "constexpr int tiles_slots(int which)"


def _head_group_2(n, causal):
    i = "blockIdx.x / n_groups"
    return [(f"block_coords({i}, p.B * p.H, {n}, {causal}, bh, ",
             f"block_coords_2({i}, p.B * p.H, {n}, {causal}, bh, ")]


_HEAD_GROUP_2 = """__device__ __forceinline__ void block_coords_2(int i, int BH, int n_qb, int causal, int& bh,
                                               int& qb) {
  const int bh0 = i / (2 * n_qb) * 2, size = min(2, BH - bh0), r = i - bh0 * n_qb;
  bh = bh0 + r % size;
  qb = causal ? n_qb - 1 - r / size : r / size;
}
"""
_SOURCE_VARIANTS = {
    "dkv_no_score_loads": ("dkv", "bfloat16", _DKV,
                           [(put, "ring.skip(pos);") for put in _SCORE_PUTS]),
    "dkv_no_loads": ("dkv", "bfloat16", _DKV,
                     [(put, "ring.skip(pos);") for put in _SCORE_PUTS + _GROUP_PUTS]),
    "fwd_f32_no_loads": ("fwd", "float32", _TILES,
                         [("if (it_kt < n_kt) {", "if (false && it_kt < n_kt) {")]),
    "fwd_f32_no_score_fmas": ("fwd", "float32", "void tiles_scores(",
                              [("d < d0 + N; d += 2", "d < d0; d += 2")]),
    "fwd_f32_no_pv": ("fwd", "float32", "void tiles_acc(",
                      [("kk < N; kk += PV", "kk < 0; kk += PV")]),
    # the f32 dq with a ring of 3 or 4 slots (the plan's slots follow)
    "dq_f32_slots_3": ("dq", "float32", _TILES_SLOTS,
                       [("which == 0 ? 3 : 2", "which == 0 ? 3 : which == 1 ? 3 : 2")], 3),
    "dq_f32_slots_4": ("dq", "float32", _TILES_SLOTS,
                       [("which == 0 ? 3 : 2", "which == 0 ? 3 : which == 1 ? 4 : 2")], 4),
    "dq_f32_head_group_2": ("dq", "float32", _DQ_TILES, _head_group_2("n_qb", "p.causal")),
    "dkv_f32_head_group_2": ("dkv", "float32", _DKV_TILES, _head_group_2("n_kb", "0")),
    # the f32 score loop one column pair a step (no unroll); dk/dv's chunk
    # loop of a score item unrolled; dk/dv with one chunk a score item (2
    # slots of the forward's size)
    "dq_f32_scores_unroll_1": ("dq", "float32", "void tiles_scores(", [_SCORES_UNROLL]),
    "dkv_f32_scores_unroll_1": ("dkv", "float32", "void tiles_scores(", [_SCORES_UNROLL]),
    "dkv_f32_chunk_loop_unrolled": ("dkv", "float32", _DKV_TILES, [
        ("#pragma unroll 1\n      for (int u = 0; u < CH; ++u)",
         "#pragma unroll\n      for (int u = 0; u < CH; ++u)", 2)]),
    "dkv_f32_one_chunk_an_item": ("dkv", "float32", "constexpr int RT_DKV_CHUNKS",
                                  [("RT_DKV_CHUNKS = 2;", "RT_DKV_CHUNKS = 1;"),
                                   ("RT_DKV_SLOT = RT_DKV_CHUNKS * (RT_KROWS + QT) * RT_LD * 4;",
                                    "RT_DKV_SLOT = RT_SLOT;")]),
}
_WAIT = "  __device__ __forceinline__ void wait(Pos p, int count) const {"
_TILES_HELPERS = "// the (batch, head) slice of an operand"
_SKIP = """  __device__ __forceinline__ void skip(Pos& p) const {
    bar_wait(&empty[p.slot], p.phase ^ 1u);
    bar_arrive(&full[p.slot]);
    p = plus(p, 1);
  }
"""


@contextlib.contextmanager
def _variant_source(fa, label):
    """Build and load ``flash_wide.cu`` with variant ``label``'s edits (each
    must occur once from its first line to the next function's end, or as
    often as its third entry says)
    from ``build/variants/<label>/``; the checkout's library again after."""
    from deeplearning4j_tpu_torch.ops import _build

    first, edits = _SOURCE_VARIANTS[label][2:4]
    text = (_build.SOURCE_DIR / "flash_wide.cu").read_text()
    assert text.count(_WAIT) == 1, "Ring::wait not found"
    text = text.replace(_WAIT, _SKIP + _WAIT)
    text = text.replace(_TILES_HELPERS, _HEAD_GROUP_2 + _TILES_HELPERS, 1)
    start = text.index(first)
    end = text.index("\n}\n", start)   # the function's closing brace
    body = text[start:end]
    for old, new, *n in edits:
        assert body.count(old) == (n[0] if n else 1), (label, old)
        body = body.replace(old, new)
    out = _build.BUILD_DIR / "variants" / label
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_wide.cu").write_text(text[:start] + body + text[end:])
    for h in _build.SOURCE_DIR.glob("*.cuh"):
        shutil.copy(h, out / h.name)

    def swap(source_dir):
        _build.SOURCE_DIR = source_dir
        _build._LIBS.pop("flash_wide", None)
        fa._wide_lib = None

    original = _build.SOURCE_DIR
    swap(out)
    try:
        yield
    finally:
        swap(original)


def _halved(plan):
    """The f32 forward's ``plan`` in column groups of 256 (the scores
    computed once a group)."""
    if plan.kernel != "fwd" or plan.route != "tiles":
        return plan
    D = sum(plan.groups)
    return dataclasses.replace(plan, groups=(256,) * (D // 256) + ((D % 256,) if D % 256 else ()),
                               acc_registers=64)


def _streamed(fa, plan):
    """``plan`` (a wgmma one) with Q (dk/dv: K and V) streamed beside the
    other operands instead of resident, and as many ring slots as then fit."""
    if plan.route != "wgmma":
        return plan
    k, D = plan.kernel, sum(plan.groups)
    slots = max(s for s in range(fa._min_slots(k, D, False), fa._MAX_SLOTS + 1)
                if fa._wgmma_bytes(k, D, s, False) <= fa._SMEM_LIMIT)
    return dataclasses.replace(plan, resident=False, slots=slots,
                               smem_bytes=fa._wgmma_bytes(k, D, slots, False))


def _train(torch, model, xt, yt, counts) -> dict:
    """A warm training step and 3 timed ones (``_fit_batch``, CUDA events),
    the loss of each and the flash launches a step, then one step split
    into forward / backward / update, and the peak memory of the timed
    steps."""
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    losses = [model._fit_batch(xt, yt, None, None)]   # the warm step
    # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = counts()
    ev[0].record()
    for _ in range(3):
        losses.append(model._fit_batch(xt, yt, None, None))
    ev[1].record()
    # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
    torch.cuda.synchronize()
    step_launches = [(b - a) / 3 for a, b in zip(c0, counts())]
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    peak = torch.cuda.max_memory_allocated()
    live = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
    ev[2].record()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, xt, yt,
                          None, None, model._gen)
    ev[3].record()
    grads = torch.autograd.grad(loss, live)
    ev[4].record()
    model._update_params(tree_unflatten_like(model.params, list(grads)))
    ev[5].record()
    # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
    torch.cuda.synchronize()
    return {"rows": int(xt.shape[0]), "step_ms": step_ms,
            "step_launches_fwd_dq_dkv": step_launches,
            "split_ms": {"forward": ev[2].elapsed_time(ev[3]),
                         "backward": ev[3].elapsed_time(ev[4]),
                         "update": ev[4].elapsed_time(ev[5])},
            "loss_sum": [float(v) for v in losses], "max_memory_allocated_bytes": peak}


def _lm(torch, fa) -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork

    rng = np.random.RandomState(4)
    x = rng.randint(0, 2048, (16, 2048)).astype(np.int64)
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(np.roll(x, -1, axis=1), device="cuda")

    def counts():
        return (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
                fa.flash_bwd_dkv_cuda.launches)

    def dispatch(model):
        """One 16 x 2048 ``output`` dispatch after a warm one: ms, launches."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        model.output(xt)
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        c0 = counts()
        ev[0].record()
        model.output(xt)
        ev[1].record()
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        return {"dispatch_16x2048_ms": ev[0].elapsed_time(ev[1]),
                "dispatch_launches_fwd_dq_dkv": [b - a for a, b in zip(c0, counts())]}

    res = {"model": {"vocab": 2048, "T": 2048, "d_model": 2048, "heads": 4, "head_dim": 512,
                     "blocks": 8, "dtype": "bfloat16"}}
    for dtype in ("bfloat16", "float32"):
        conf = zoo.TransformerLM(vocab_size=2048, max_len=2048, d_model=2048, n_heads=4,
                                 n_blocks=8, dtype=dtype, seed=12345,
                                 updater={"type": "adam", "lr": 1e-4})
        model = MultiLayerNetwork(conf).init()
        run = dispatch(model)
        run.update(_train(torch, model, xt, yt, counts))
        res["model"]["params"] = model.num_params()
        if dtype == "bfloat16":
            res.update(run)
        else:
            res["float32"] = run
        del model
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--lm", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("wide_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"label": args.label, "root": os.path.abspath(args.root), "card": _card(),
           "kernels": _kernels(torch, fa, args.variants)}
    if args.lm:
        res["lm"] = _lm(torch, fa)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
