"""The PyTorch port imports neither jax nor the JAX package.

A subprocess imports every module of ``deeplearning4j_tpu_torch`` (and the
imports ``chip_smoke.py`` makes) and checks ``sys.modules``; a static scan
of the port's sources and of ``chip_smoke.py`` finds no ``jax`` or
``deeplearning4j_tpu`` import.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deeplearning4j_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _smoke_imports():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return sorted(mods)


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules() + _smoke_imports()
    assert "deeplearning4j_tpu_torch.serve.server" in mods
    assert "deeplearning4j_tpu_torch.ops.fused_lstm" in mods
    assert "deeplearning4j_tpu_torch.nn.layers.recurrent" in mods
    for m in ("nn.layers.convolution", "nn.layers.pooling", "nn.layers.normalization",
              "nn.layers.core", "nn.preprocessors", "models.zoo", "interop",
              "nn.graph", "nn.transfer", "nn.layers.custom", "nn.layers.variational",
              "nn.layers.objdetect", "models.zoo_graph", "parallel", "parallel.context",
              "parallel.mesh", "parallel.distributed", "parallel.ring", "parallel.tp",
              "nlp", "nlp.tokenization", "nlp.vocab", "nlp.cjk", "nlp.vectorizers",
              "nlp.embeddings", "nlp.serializer", "nlp.glove", "nlp.distributed", "graph",
              "graph.api", "graph.loader", "graph.walks", "graph.deepwalk",
              "graph.node2vec", "utils.misc", "clustering", "clustering.knn",
              "clustering.kmeans", "clustering.lsh", "clustering.sptree",
              "clustering.trees", "clustering.tsne", "clustering.server",
              "clustering.__main__", "search", "search.index", "search.program"):
        assert f"deeplearning4j_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'deeplearning4j_tpu' or k.startswith('deeplearning4j_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = []
    for path in sources:
        for name in _imported_names(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "deeplearning4j_tpu"):
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert offenders == []
