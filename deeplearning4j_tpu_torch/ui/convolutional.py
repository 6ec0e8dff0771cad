"""ConvolutionalIterationListener — activation-grid visualization.

Capability parity with the reference's
ui/weights/ConvolutionalIterationListener.java:38 (iterationDone:110
rasterizes each conv layer's activation channels into one image and streams
it to the UI). As in the JAX package, the listener re-runs an
inference-mode ``feed_forward`` on a caller-provided probe batch every
``frequency`` iterations (the port's NHWC activations, copied to the host)
and writes per-layer channel grids as PNGs (pure-stdlib zlib encoder —
air-gapped, no PIL) plus an index HTML built from the `ui/components.py`
DSL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np


def _host(a) -> np.ndarray:
    """An activation as a float32 host array (tensors from any device)."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (stdlib only). ``img``: [H,W]
    uint8."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected [H,W] grayscale, got shape {img.shape}")
    h, w = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit gray
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def activation_grid(act: np.ndarray, max_channels: int = 64,
                    border: int = 1) -> np.ndarray:
    """Tile an [H,W,C] activation into one ~square uint8 grid image, each
    channel min-max normalized independently (the reference rasterizes each
    channel as its own gray patch, rasterizeConvoLayers:181)."""
    act = np.asarray(act, np.float32)
    if act.ndim != 3:
        raise ValueError(f"expected [H,W,C], got shape {act.shape}")
    h, w, c = act.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    out = np.zeros((rows * (h + border) + border,
                    cols * (w + border) + border), np.uint8)
    for i in range(c):
        ch = act[:, :, i]
        lo, hi = float(ch.min()), float(ch.max())
        norm = (ch - lo) / (hi - lo) if hi > lo else np.zeros_like(ch)
        r, col = divmod(i, cols)
        y0 = border + r * (h + border)
        x0 = border + col * (w + border)
        out[y0:y0 + h, x0:x0 + w] = (norm * 255).astype(np.uint8)
    return out


class ConvolutionalIterationListener:
    """Every ``frequency`` iterations, renders channel grids of every
    conv-shaped (4-D) activation for ``probe_input`` into ``out_dir``.

    ``probe_input``: [1,H,W,C] (or [B,...]; only the first example is
    rendered, like the reference's minibatch slice)."""

    def __init__(self, probe_input, out_dir: str, frequency: int = 10,
                 max_channels: int = 64):
        if frequency < 1:
            raise ValueError(f"frequency must be >= 1: {frequency}")
        self.probe = np.asarray(probe_input)[:1]
        self.out_dir = out_dir
        self.frequency = frequency
        self.max_channels = max_channels
        self.rendered: List[str] = []
        os.makedirs(out_dir, exist_ok=True)

    # TrainingListener SPI ------------------------------------------------
    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_gradient_calculation(self, model, iteration: int):
        pass

    def iteration_done(self, model, iteration: int, score: float,
                       batch_size: int = 0):
        if iteration % self.frequency != 0:
            return
        acts = model.feed_forward(self.probe, train=False)
        paths = []
        for li, a in enumerate(acts):
            a = _host(a)
            if a.ndim != 4:  # only conv-shaped [B,H,W,C] activations
                continue
            grid = activation_grid(a[0], self.max_channels)
            p = os.path.join(self.out_dir, f"iter{iteration:06d}_layer{li}.png")
            with open(p, "wb") as f:
                f.write(encode_png_gray(grid))
            paths.append(p)
        self.rendered.extend(paths)
        self._write_index()

    def _write_index(self) -> None:
        from deeplearning4j_tpu_torch.ui.components import (
            ComponentText, render_html)

        imgs = "".join(
            f'<div class="card"><h3>{os.path.basename(p)}</h3>'
            f'<img src="{os.path.basename(p)}"/></div>'
            for p in self.rendered)
        page = render_html(
            ComponentText("Convolutional activations (probe example 0)"),
            title="convolutional activations")
        page = page.replace("</body>", imgs + "</body>")
        with open(os.path.join(self.out_dir, "index.html"), "w") as f:
            f.write(page)
