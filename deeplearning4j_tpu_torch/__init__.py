"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, with the same module structure,
config JSON, parameter layouts and names, held against the JAX package by
parity tests. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path becomes a hand-written CUDA kernel for Hopper (``csrc/``),
built at first use (``ops/_build.py``).

Ported so far: the TransformerLM serving and training paths — config
serde (``nn/config.py``, ``nn/model.py``), the layers they use, the
flash-attention forward and backward kernels (``ops/flash_attention.py``),
losses, updaters, constraints and the fit loop (``nn/losses.py``,
``train/updaters.py``, ``nn/constraints.py``, ``nn/step_program.py``),
listeners and evaluation, the checkpoint zip shared with the JAX package
(``utils/serialization.py``), the trainer CLI
(``python -m deeplearning4j_tpu_torch.train``), the bucket ladder
(``utils/bucketing.py``), observability (``obs/``) and the HTTP
``:predict`` tier (``serve/``); since then the char-RNN, the image and
graph models, the training runtime, sequence parallelism, generation and
MoE, the embedding libraries, search and clustering, and model import
(``modelimport/``: DL4J zips and Keras files) with the data path
(``datasets/``, the C++ parsers of ``native/``). Entry points run on the
GPU unless the caller passes ``device="cpu"``.

Importing this package imports neither ``jax`` nor ``deeplearning4j_tpu``.
"""

__version__ = "0.1.0"
