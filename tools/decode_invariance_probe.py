#!/usr/bin/env python3
"""Whether a decode step's rows depend on their batch, op by op, and how
the MoE TransformerLM routes with and without the flash kernels.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/decode_invariance_probe.py [--rates 1 3 6 12 24]

At the full TransformerLM width of ``chip_smoke.py`` (bf16, random weights
from the seed) it prints one JSON line each for:

1. ``gemm_rows``: ``x[:m] @ W`` against the first m rows of ``x @ W`` at 8
   rows (m = 1, 2, 4; the decode step's GEMM shapes), bit for bit;
2. ``attention``: ``decode_attention`` of row 0 alone against row 0 of 8,
   and over spans of 256, 1024, 2048 and 2049 keys against 128 (the keys
   past 128 zero and masked);
3. ``per_row_ops``: for each of 8 streams prefilled into the page pool,
   the first op of the step (embedding, each block's layer norms, GEMMs,
   attention and MLP, the final norm and the logits) whose output for the
   stream differs between the 8-row step and the stream's step alone;
4. ``teacher_forced``: 8 streams decoded 32 tokens alone, then again fed
   the same tokens at 8 rows, alone with the narrowest table, and through
   the contiguous layout: bit-equal logits, largest difference, greedy
   flips, and the top-2 margins of the logits;
5. ``moe_routing``: ``TransformerLM(moe_experts=8)`` on 4 x 2048 tokens,
   in bf16 and in an f32 replica of the same weights: tokens each MoE
   layer routes to another expert with use_flash=False than with the
   kernels, and the parameter gradients' largest relative difference;
6. with ``--rates``: ``chip_smoke.generate_phase`` with those open-loop
   arrival rates (streams/s, 4 s each) in place of its own, its load rows.

The smoke's generate and moe_train phases hold what this finds; this
probe says where a difference comes from when they fail.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.nn.decode import DecodeProgram, _PagedView  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import MixtureOfExperts, TransformerBlock  # noqa: E402
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402


def emit(key, value):
    print(json.dumps({key: value}, default=str), flush=True)


def gemm_rows(dev, g):
    out = {}
    for K, N in ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)):
        W = torch.randn(K, N, device=dev, generator=g).bfloat16()
        x = torch.randn(8, K, device=dev, generator=g).bfloat16()
        y8 = x @ W
        out[f"K{K}_N{N}"] = {m: bool(torch.equal(x[:m] @ W, y8[:m])) for m in (1, 2, 4)}
    return out


def attention(dev, g):
    q = torch.randn(8, 1, 16, 128, device=dev, generator=g).bfloat16()
    k, v = (torch.randn(8, 2048, 16, 128, device=dev, generator=g).bfloat16()
            for _ in range(2))
    pos = torch.full((8, 1), 100, device=dev)
    rows = bool(torch.equal(fa.decode_attention(q, k, v, pos)[:1],
                            fa.decode_attention(q[:1], k[:1], v[:1], pos[:1])))
    base = fa.decode_attention(q, k[:, :128], v[:, :128], pos)
    spans = {}
    for K in (256, 1024, 2048, 2049):
        kk, vv = (torch.zeros(8, K, 16, 128, device=dev).bfloat16() for _ in range(2))
        kk[:, :128], vv[:, :128] = k[:, :128], v[:, :128]
        spans[K] = bool(torch.equal(base, fa.decode_attention(q, kk, vv, pos)))
    return {"row0_alone_equals_row0_of_8": rows, "span_equals_span_128": spans}


def _prefill(prog, prompts):
    """Each prompt into its own 32 pages; returns the cached lengths."""
    cached = []
    for i, p in enumerate(prompts):
        table = (1 + i * prog.max_pages + np.arange(prog.max_pages))[None]
        c = 0
        for s in range(0, len(p), prog.prefill_chunk):
            chunk = p[s:s + prog.prefill_chunk]
            tc = prog.ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
            toks = np.zeros((1, tc), np.int64)
            toks[0, :len(chunk)] = chunk
            prog.dispatch(table, [c], toks, [len(chunk)])
            c += len(chunk)
        cached.append(c)
    return cached


def per_row_ops(model, prog, prompts):
    """The step walked by hand (no cache write) for rows ``rows`` of the 8
    streams: every intermediate output by name."""
    dev, params = prog.device, model.params
    cached = _prefill(prog, prompts)
    table8 = torch.as_tensor(1 + np.arange(8 * prog.max_pages).reshape(8, -1), device=dev)
    len8 = torch.as_tensor(cached, device=dev)

    def walk(rows):
        pos = len8[rows][:, None]
        valid = torch.ones(len(rows), 1, dtype=torch.bool, device=dev)
        a = model.layers[0].apply(params[0], None, torch.full((len(rows), 1), 5, device=dev))[0]
        a = model.layers[1].decode_apply(params[1], a, pos)
        outs = {"embed": a}
        bi = 0
        for li, layer in enumerate(model.layers):
            if not isinstance(layer, TransformerBlock):
                continue
            p, B, C = params[li], len(rows), a.shape[-1]
            H = layer.n_heads
            h = layer._ln(p["ln1"], a)
            outs[f"b{bi}.ln1"] = h
            qkv = h @ p["attn"]["Wqkv"] + p["attn"]["bqkv"]
            outs[f"b{bi}.qkv"] = qkv
            q = qkv.view(B, 1, 3 * H, C // H)[:, :, :H]
            view = _PagedView(prog.pools[bi], table8[rows], pos, valid, prog.page_tokens)
            att = fa.decode_attention(q, *view.gathered(), pos)
            outs[f"b{bi}.attention"] = att
            a = a + (att.reshape(B, 1, C) @ p["attn"]["Wo"] + p["attn"]["bo"])
            outs[f"b{bi}.attn_out"] = a
            h = layer._ln(p["ln2"], a)
            outs[f"b{bi}.ln2"] = h
            h = layer.activation_fn()(h @ p["Wi"] + p["bi"])
            outs[f"b{bi}.mlp_hidden"] = h
            a = a + (h @ p["Wo"] + p["bo"])
            outs[f"b{bi}.out"] = a
            bi += 1
        a = model.layers[-2].apply(params[-2], None, a)[0]
        outs["final_norm"] = a
        outs["logits"] = model.layers[-1].preactivation(params[-1], a[:, 0])
        return outs

    with torch.inference_mode():
        all8 = walk(list(range(8)))
        first = {}
        for r in range(8):
            alone = walk([r])
            first[r] = next((k for k in all8 if not torch.equal(all8[k][r:r + 1], alone[k])),
                            None)
    return first


def teacher_forced(model, prompts, n_gen=32):
    prog = DecodeProgram(model, page_tokens=64, max_batch=8, prefill_chunk=64)
    ref, ids = cs._drive_program(prog, prompts, n_gen, together=False)
    runs = {}
    prog.reset()
    runs["batched_vs_alone"] = cs._drive_program(prog, prompts, n_gen, together=True,
                                                 force=ids)[0]
    contig = DecodeProgram(model, page_tokens=64, max_batch=8, prefill_chunk=64,
                           paged=False)
    runs["contiguous_vs_paged"] = _drive_contiguous(contig, prompts, ids, n_gen)
    out = {}
    for name, got in runs.items():
        out[name] = {"bit_equal": all(torch.equal(a, b) for a, b in zip(got, ref)),
                     "max_abs_diff": max((a - b).abs().max().item() for a, b in zip(got, ref)),
                     "greedy_flips": sum(int((a.argmax(-1) != b.argmax(-1)).sum())
                                         for a, b in zip(got, ref))}
    top2 = torch.cat([l.topk(2, dim=-1).values for l in ref])
    margin = top2[:, 0] - top2[:, 1]
    out["top2_margin"] = {"min": margin.min().item(), "under_0.05": int((margin < 0.05).sum()),
                          "steps": margin.numel()}
    return out


def _drive_contiguous(prog, prompts, force, n_gen):
    """Each stream alone through the contiguous layout, fed ``force``."""
    logits = []
    for i, p in enumerate(prompts):
        slot, c, rows = np.array([i]), 0, []
        for s in range(0, len(p), prog.prefill_chunk):
            chunk = p[s:s + prog.prefill_chunk]
            tc = prog.ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
            toks = np.zeros((1, tc), np.int64)
            toks[0, :len(chunk)] = chunk
            lg, _ = prog.dispatch(slot, [c], toks, [len(chunk)])
            c += len(chunk)
        rows.append(lg[0].cpu())
        for step in range(1, n_gen):
            lg, _ = prog.dispatch(slot, [c], [[force[i][step - 1]]], [1])
            c += 1
            rows.append(lg[0].cpu())
        logits.append(torch.stack(rows))
    return logits


def moe_routing():
    conf = zoo.TransformerLM(moe_experts=8, **cs.FLAGSHIP_CONF)
    model = MultiLayerNetwork(conf).init()
    x = torch.as_tensor(np.random.RandomState(51).randint(0, 2048, (4, 2048)),
                        device=model.device)
    y = torch.roll(x, -1, dims=1)
    out = {"bfloat16": cs._moe_vs_use_flash_false(model, x, y)}
    f32 = MultiLayerNetwork(zoo.TransformerLM(moe_experts=8,
                                              **dict(cs.FLAGSHIP_CONF, dtype="float32")))
    f32.params = cs.tree_unflatten_like(
        model.params, [t.float() for t in cs.tree_leaves(model.params)])
    f32.state = model.state
    out["float32"] = cs._moe_vs_use_flash_false(f32, x, y)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rates", type=float, nargs="*", default=None,
                    help="also run the generate phase at these arrival rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_invariance_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    emit("gemm_rows", gemm_rows(dev, g))
    emit("attention", attention(dev, g))
    model = MultiLayerNetwork(zoo.TransformerLM(**cs.FLAGSHIP_CONF)).init()
    prompts = cs._gen_prompts(cs.GEN_PROMPTS, 21) + cs._gen_prompts(cs.GEN_EXTRA, 22)
    prog = DecodeProgram(model, page_tokens=64, max_batch=8, prefill_chunk=64)
    emit("per_row_ops", per_row_ops(model, prog, prompts))
    del prog
    emit("teacher_forced", teacher_forced(model, prompts))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit("moe_routing", moe_routing())
    gc.collect()
    torch.cuda.empty_cache()
    if args.rates:
        cs.LOAD_RATES, cs.LOAD_WINDOW_S = tuple(args.rates), 4.0
        emit("load", cs.generate_phase()["load"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
