"""Time ``fit``'s loop on the card for the port found under ``--root``.

    python3 deeplearning4j_tpu_torch/tools/fit_loop_bench.py [--root DIR]

``--root`` is the directory holding the ``deeplearning4j_tpu_torch``
package to measure (default: this checkout), so one copy of the script
times two checkouts, each in its own process; run them interleaved (A, B,
B, A) in one session of one card to compare them. Prints one JSON line:

- ``lenet_listener``: LeNet-5 (28 x 28 x 1, f32, Adam 1e-3), 2048 random
  images, batch 256, 2 epochs, with a listener that reads each score back
  (as ``chip_smoke.py``'s cnn_train does through the trainer): samples/s
  over the last epoch on the host clock;
- ``lenet_no_listener``: the same model on 32 batches of 256 with no
  listener (the chained path where the checkout has one): ms a step by
  CUDA events around ``fit``;
- ``char_rnn_listener``: the GravesLSTM char-RNN (77 symbols, 256 units,
  f32, RMSProp, tBPTT 50) on 256 sequences of 200, batch 128, 2 epochs,
  with the score-reading listener: ms a tBPTT chunk over the last epoch;
- ``transformer_lm``: the full-width TransformerLM (vocab 2048, T 2048,
  d_model 2048, 16 heads, 8 blocks, bf16, Adam 1e-4: 3.3 GB of updater
  state), one model fitting 4 batches of 16 x 2048 tokens a call, no
  listener: ms a step by CUDA events around ``fit``.

Each is run once to warm up (kernel builds, cuDNN's autotuning) and then
timed; the card's name and power limit go with the line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    class Stamps(TrainingListener):
        """The host time after each score is read back."""

        def __init__(self):
            self.t = []

        def iteration_done(self, model, iteration, score, *a, **k):
            self.t.append(time.perf_counter())

    rs = np.random.RandomState(34)
    x = rs.rand(2048, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 2048)]
    out = {"root": os.path.abspath(args.root), "label": args.label, "card": _card()}

    def lenet_listener():
        m = MultiLayerNetwork(zoo.LeNet5()).init()
        lis = Stamps()
        m.set_listeners(lis)
        m.fit((x, y), epochs=2, batch_size=256)
        per_epoch = 2048 // 256
        return 2048 / (lis.t[-1] - lis.t[-per_epoch - 1])

    def lenet_no_listener():
        xs, ys = np.concatenate([x] * 4), np.concatenate([y] * 4)
        m = MultiLayerNetwork(zoo.LeNet5()).init()
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m.fit((xs, ys), epochs=1, batch_size=256)
        ev[1].record()
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / (len(xs) // 256)

    ids = np.random.RandomState(8).randint(0, 77, (256, 200))
    eye = np.eye(77, dtype=np.float32)
    cx, cy = eye[ids], eye[np.roll(ids, -1, axis=1)]

    def char_rnn_listener():
        m = MultiLayerNetwork(zoo.TextGenerationLSTM(
            vocab_size=77, timesteps=50, hidden=256, dtype="float32", seed=12345)).init()
        lis = Stamps()
        m.set_listeners(lis)
        m.fit((cx, cy), epochs=2, batch_size=128)
        per_epoch = 256 // 128   # one listener call a batch of 4 chunks
        return (lis.t[-1] - lis.t[-per_epoch - 1]) * 1e3 / (per_epoch * 200 // 50)

    lm_ids = np.random.RandomState(4).randint(0, 2048, (64, 2048)).astype(np.int64)
    lm = []

    def transformer_lm():
        if not lm:
            lm.append(MultiLayerNetwork(zoo.TransformerLM(
                vocab_size=2048, max_len=2048, d_model=2048, n_heads=16, n_blocks=8,
                dtype="bfloat16", seed=12345, updater={"type": "adam", "lr": 1e-4})).init())
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lm[0].fit((lm_ids, np.roll(lm_ids, -1, axis=1)), epochs=1, batch_size=16)
        ev[1].record()
        # graftlint: disable=host-sync; a timing harness: the sync ends the timed region
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / (len(lm_ids) // 16)

    for name, fn in (("lenet_listener_samples_per_s", lenet_listener),
                     ("lenet_no_listener_ms_per_step", lenet_no_listener),
                     ("char_rnn_listener_ms_per_chunk", char_rnn_listener),
                     ("transformer_lm_ms_per_step", transformer_lm)):
        fn()   # warm: builds, autotuning, allocator
        out[name] = [fn() for _ in range(3)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
