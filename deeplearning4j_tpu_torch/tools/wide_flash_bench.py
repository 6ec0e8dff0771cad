"""Time the wide-head flash kernels (head dims past 256) on the card for the
port found under ``--root``.

    python3 deeplearning4j_tpu_torch/tools/wide_flash_bench.py [--root DIR] [--lm] [--variants]

``--root`` is the directory holding the ``deeplearning4j_tpu_torch``
package to measure (default: this checkout), so one copy of the script
times two checkouts, each in its own process; run them interleaved (A, B,
B, A) in one call on one card to compare them. Prints one JSON line:

- ``kernels``: the forward, dq and dk/dv through the port's wrappers
  (``flash_fwd_cuda``, ``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda``), bf16,
  causal, by CUDA events, at B16 T2048 H4 D512 (the products of kernel
  #1's flagship shape, B16 T2048 H16 D128), B2 T512 H4 at D 320 and 512,
  and B1 T256 H2 at D 3072 (column groups), each beside its bound and
  ``scaled_dot_product_attention``'s forward and backward;
- with ``--variants`` (a checkout with ``wide_plan``): the forward with Q
  streamed beside Q resident, and dk/dv with K and V streamed beside
  resident, at B16 T2048 H4 D512 (the streamed plans are built here from
  ``wide_plan``'s), and dk/dv built with its producer skipping the score
  steps' Q and dO boxes, or every Q and dO box (``_LOAD_VARIANTS``: what
  the box stream costs it);
- with ``--lm``: the flagship TransformerLM of ``bench.py:546`` with 4
  heads (D = 512: vocab 2048, T 2048, d_model 2048, 8 blocks, bf16, seed
  12345, Adam 1e-4): one 16 x 2048 ``output`` dispatch (ms, CUDA events,
  after a warm one), then a warm training step and 3 timed ones
  (``_fit_batch``, CUDA events) with one step split into forward /
  backward / update, the loss of each, and the launches of each flash
  kernel a dispatch and a step.

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

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _bounds(B, T, H, D):
    """Forward and dk/dv bounds (ms) at a causal bf16 shape: their products
    over the kept pairs (2 and 4 of 2 B H pairs D flops) at the bf16 peak,
    against q, k, v, out (and do, lse, delta, dk, dv) moved once."""
    pairs = T * (T + 1) // 2
    prod = 2.0 * B * H * pairs * D
    fwd = max(2 * prod / PEAK_BF16, (4 * B * T * H * D * 2 + 4 * B * H * T) / PEAK_BYTES)
    dkv = max(4 * prod / PEAK_BF16, (6 * B * T * H * D * 2 + 8 * B * H * T) / PEAK_BYTES)
    return fwd * 1e3, dkv * 1e3


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
    shapes = ((16, 2048, 4, 512, 5), (2, 512, 4, 320, 20), (2, 512, 4, 512, 20),
              (1, 256, 2, 3072, 10))
    for B, T, H, D, iters in shapes:
        g = torch.Generator(device="cuda").manual_seed(D)
        qkv = torch.randn(B, T, 3 * H, D, generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(H, dim=2)   # the fused-qkv views the attention layer passes
        o, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
        do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
        delta = fa._delta(o, do)
        row = {"shape": [B, T, H, D], "dtype": "bfloat16", "causal": True,
               "fwd_ms": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal=True), iters),
               "dkv_ms": time_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None,
                                                               True), iters),
               "dq_ms": time_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None,
                                                             True), max(1, iters // 4), 1)}
        row["fwd_bound_ms"], row["dkv_bound_ms"] = _bounds(B, T, H, D)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["sdpa_fwd_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        og = sdpa(qg, kg, vg, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                                                 retain_graph=True), iters)
        if variants and (B, T, H, D) == (16, 2048, 4, 512) and hasattr(fa, "wide_plan"):
            plan = fa.wide_plan
            try:
                fa.wide_plan = lambda kern, d, dt: _streamed(fa, plan(kern, d, dt))
                row["fwd_q_streamed_ms"] = time_ms(
                    lambda: fa.flash_fwd_cuda(q, k, v, causal=True), iters)
                row["dkv_kv_streamed_ms"] = time_ms(
                    lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True), iters)
                row["streamed_plans"] = {kern: str(fa.wide_plan(kern, D, torch.bfloat16))
                                         for kern in ("fwd", "dkv")}
            finally:
                fa.wide_plan = plan
            for label, puts in _LOAD_VARIANTS.items():
                with _variant_source(fa, label, puts):
                    row[f"dkv_{label}_ms"] = time_ms(
                        lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True),
                        iters)
        out.append(row)
        del q, k, v, qkv, o, lse, do, delta, qt, kt, vt, qg, kg, vg, og, dot
        torch.cuda.empty_cache()
    return out


# dk/dv variants that load fewer of the boxes the producer streams through
# the ring (timing only: their results are not attention). The producer
# arrives on a skipped box's barrier without loading it, so the consumers
# run the same products and exchanges on whatever the slot held:
# "no_score_loads" skips the score steps' Q and dO boxes (all of D), and
# "no_loads" also the group's boxes of the accumulation steps.
_SCORE_PUTS = ("ring.put(pos, &p.q, c * BOX, h, q0, b);",
               "ring.put(pos, &p.o, c * BOX, h, q0, b);")
_GROUP_PUTS = ("ring.put(pos, &p.q, (gb + j) * BOX, h, q0, b);",
               "ring.put(pos, &p.o, (gb + j) * BOX, h, q0, b);")
_LOAD_VARIANTS = {"no_score_loads": _SCORE_PUTS, "no_loads": _SCORE_PUTS + _GROUP_PUTS}
_WAIT = "  __device__ __forceinline__ void wait(Pos p, int count) const {"
_SKIP = """  __device__ __forceinline__ void skip(Pos& p) const {
    bar_wait(&empty[p.slot], p.phase ^ 1u);
    bar_arrive(&full[p.slot]);
    p = plus(p, 1);
  }
"""


@contextlib.contextmanager
def _variant_source(fa, label, puts):
    """Build and load ``flash_wide.cu`` with the dk/dv kernel's producer
    skipping ``puts`` (each must occur once in that kernel) from
    ``build/variants/<label>/``; the checkout's library again after."""
    from deeplearning4j_tpu_torch.ops import _build

    src = _build.SOURCE_DIR / "flash_wide.cu"
    text = src.read_text()
    cut = text.index("flash_wide_dkv_wgmma_kernel(__grid_constant__")
    head, dkv = text[:cut], text[cut:]
    assert head.count(_WAIT) == 1, "Ring::wait not found"
    head = head.replace(_WAIT, _SKIP + _WAIT)
    for put in puts:
        assert dkv.count(put) == 1, put
        dkv = dkv.replace(put, "ring.skip(pos);")
    out = _build.BUILD_DIR / "variants" / label
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_wide.cu").write_text(head + dkv)
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


def _lm(torch, fa) -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

    conf = zoo.TransformerLM(vocab_size=2048, max_len=2048, d_model=2048, n_heads=4,
                             n_blocks=8, dtype="bfloat16", seed=12345,
                             updater={"type": "adam", "lr": 1e-4})
    model = MultiLayerNetwork(conf).init()
    rng = np.random.RandomState(4)
    x = rng.randint(0, 2048, (16, 2048)).astype(np.int64)
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(np.roll(x, -1, axis=1), device="cuda")

    def counts():
        return (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
                fa.flash_bwd_dkv_cuda.launches)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    model.output(xt)
    # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
    torch.cuda.synchronize()
    c0 = counts()
    ev[0].record()
    model.output(xt)
    ev[1].record()
    # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
    torch.cuda.synchronize()
    dispatch_ms = ev[0].elapsed_time(ev[1])
    dispatch_launches = [b - a for a, b in zip(c0, counts())]
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
    losses = [float(v) for v in losses]
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    step_launches = [(b - a) / 3 for a, b in zip(c0, counts())]
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
    return {"model": {"vocab": 2048, "T": 2048, "d_model": 2048, "heads": 4, "head_dim": 512,
                      "blocks": 8, "dtype": "bfloat16", "params": model.num_params()},
            "dispatch_16x2048_ms": dispatch_ms,
            "dispatch_launches_fwd_dq_dkv": dispatch_launches,
            "step_16x2048_ms": step_ms, "step_launches_fwd_dq_dkv": step_launches,
            "split_ms": {"forward": ev[2].elapsed_time(ev[3]),
                         "backward": ev[3].elapsed_time(ev[4]),
                         "update": ev[4].elapsed_time(ev[5])},
            "loss_sum": losses, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


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
