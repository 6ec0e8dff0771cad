"""graftlint fixture: durable-store-protocol true positives."""

import os
import zipfile

import torch


def save_checkpoint(obj, d):
    torch.save(obj, os.path.join(d, "checkpoint.pt"))       # BAD: not atomic


def save_bundle(d, payload):
    with zipfile.ZipFile(os.path.join(d, "model.aotbundle"), "w") as zf:   # BAD
        zf.writestr("manifest.json", payload)


def write_manifest(d, text):
    with open(os.path.join(d, "manifest.json"), "w") as f:  # BAD
        f.write(text)


def save_checkpoint_atomic(obj, d):
    final = os.path.join(d, "checkpoint.pt")
    tmp = final + ".tmp"
    torch.save(obj, tmp)                                    # OK: tmp, then
    os.replace(tmp, final)                                  # an atomic rename


def save_scratch(obj, d):
    torch.save(obj, os.path.join(d, "scratch.pt"))          # OK: not durable
