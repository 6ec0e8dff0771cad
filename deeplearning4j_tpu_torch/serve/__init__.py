"""serve/ — continuous-batching inference tier (PyTorch port).

An HTTP/JSON front (serve/server.py) over per-model continuous-batching
pools (serve/scheduler.py) whose coalescing decisions are deadline
admission math over measured per-bucket latency (serve/admission.py), fed
by the register → warm → serve registry (serve/registry.py). Shared HTTP
plumbing (SLO envelope, /metrics, /healthz) lives in serve/httpcommon.py.

Quick start::

    from deeplearning4j_tpu_torch import serve
    from deeplearning4j_tpu_torch.models import TransformerLM
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork

    model = MultiLayerNetwork(TransformerLM()).init()      # on the GPU
    registry = serve.ModelRegistry()
    registry.register("lm", model)                          # warm + serve
    srv = serve.InferenceServer(registry).start(port=8000)
    # POST /v1/models/lm:predict {"inputs": [[ids...]], "deadline_ms": 500}
    registry.register_generate("lm", model)                 # token streams
    # POST /v1/models/lm:generate {"prompt": [ids...], "max_tokens": 32}

A model trained elsewhere is served from its file:
``registry.load(name, "model.zip" or "model.h5")`` imports it
(``modelimport.import_model``) onto the registry's device and registers it;
``python -m deeplearning4j_tpu_torch.serve name=path [...] --port N``
does the same from the command line.

Vector search rides the same tier: ``registry.register_index(name,
index)`` puts a device-resident ANN index (``search/``) behind a
signature-coalescing :class:`~.scheduler.SearchWorker`, served as
``POST /v1/search`` plus the legacy ``/knn`` / ``/knnnew`` / ``/status``
contract; search adds ``DL4J_TPU_SEARCH_BATCH_MAX``,
``DL4J_TPU_IVF_NLIST``, ``DL4J_TPU_IVF_NPROBE`` (build-time knobs).

Knobs (the JAX package's names): ``DL4J_TPU_SERVE_MAX_BATCH``,
``DL4J_TPU_SERVE_QUEUE``, ``DL4J_TPU_SERVE_MARGIN_MS``,
``DL4J_TPU_SERVE_WAIT_MS``, ``DL4J_TPU_SERVE_WAIT_QUANTUM_MS``,
``DL4J_TPU_SERVE_DEFAULT_DEADLINE_MS``, ``DL4J_TPU_SERVE_MIN_SAMPLES``,
``DL4J_TPU_SERVE_WORKERS``; for generation ``DL4J_TPU_DECODE_BATCH_MAX``,
``DL4J_TPU_KV_PAGE_TOKENS``, ``DL4J_TPU_KV_PAGED``,
``DL4J_TPU_PREFILL_CHUNK``, ``DL4J_TPU_GEN_MAX_NEW``,
``DL4J_TPU_GEN_QUEUE``, ``DL4J_TPU_GEN_DEADLINE_MS``.
"""

from deeplearning4j_tpu_torch.serve.admission import (
    AdmissionController, GenerateConfig, LatencyModel, ServeConfig,
    TokenAdmission)
from deeplearning4j_tpu_torch.serve.registry import ModelRegistry
from deeplearning4j_tpu_torch.serve.scheduler import (
    GenerateStream, GenerateWorker, ModelWorker, SearchWorker, ShedError)
from deeplearning4j_tpu_torch.serve.server import InferenceServer

__all__ = [
    "AdmissionController",
    "GenerateConfig",
    "GenerateStream",
    "GenerateWorker",
    "InferenceServer",
    "LatencyModel",
    "ModelRegistry",
    "ModelWorker",
    "SearchWorker",
    "ServeConfig",
    "ShedError",
    "TokenAdmission",
]
