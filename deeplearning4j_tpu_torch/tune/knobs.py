"""Typed registry of the framework's performance knobs (PyTorch port).

The registry is the JAX package's, entry for entry (``registry_dict()``
is equal in both), so a tuning DB names knobs alike in either package.
``flash_block_q``, ``flash_block_k`` and ``rnn_unroll`` set Pallas block
sizes and a scan unroll that the port has no counterpart for: they stay
registered, and ``tune.search.tune_model`` refuses to search them
(:data:`INERT`).

Every knob the tuner may turn is declared here once: its environment
variable, the value domain worth searching, the built-in default, and the
scope it acts in (``fit`` — the training step builder; ``serve`` — the
inference/dispatch path; ``both``). The registry is the single source of
truth shared by the search (`tune.search` enumerates domains from it), the
tuning DB (entries store knob *names*, resolved back through the registry
at apply time), and the docs.

Knobs act through environment variables read at step-BUILD time, never
inside a trace — applying one therefore only affects executables compiled
afterwards, which is why `tune.maybe_apply` runs at fit()/serve startup
before anything compiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

__all__ = ["INERT", "Knob", "KNOBS", "get", "all_knobs", "registry_dict"]

_KINDS = ("int", "float", "str")
_SCOPES = ("fit", "serve", "both")


@dataclass(frozen=True)
class Knob:
    """One tunable: ``domain`` is the ordered candidate set the search
    enumerates (declaration order is the deterministic trial order);
    ``default`` must be a member of ``domain`` so the un-tuned baseline is
    always in the race and the winner is ≥ default by construction."""

    name: str
    env: str
    kind: str          # "int" | "float" | "str"
    domain: Tuple[Any, ...]
    default: Any
    scope: str         # "fit" | "serve" | "both"
    help: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"knob {self.name}: bad kind {self.kind!r}")
        if self.scope not in _SCOPES:
            raise ValueError(f"knob {self.name}: bad scope {self.scope!r}")
        if self.default not in self.domain:
            raise ValueError(
                f"knob {self.name}: default {self.default!r} not in domain")

    # -- value plumbing ----------------------------------------------------

    def parse(self, raw: str) -> Any:
        """Env-string → typed value (the inverse of ``format``)."""
        if self.kind == "int":
            return int(raw)
        if self.kind == "float":
            return float(raw)
        return str(raw)

    def format(self, value: Any) -> str:
        """Typed value → the exact string the consuming env reader expects."""
        if self.kind == "int":
            return str(int(value))
        if self.kind == "float":
            return repr(float(value))
        return str(value)

    def validate(self, value: Any) -> Any:
        """Round-trip ``value`` through the env encoding and check domain
        membership. Returns the canonical typed value."""
        v = self.parse(self.format(value))
        if v not in self.domain:
            raise ValueError(
                f"knob {self.name}: {value!r} not in domain {self.domain}")
        return v

    def applies_to(self, scope: str) -> bool:
        return self.scope == "both" or self.scope == scope

    # -- serde (DB + tests round-trip through this) ------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "env": self.env, "kind": self.kind,
            "domain": list(self.domain), "default": self.default,
            "scope": self.scope, "help": self.help,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Knob":
        return Knob(
            name=d["name"], env=d["env"], kind=d["kind"],
            domain=tuple(d["domain"]), default=d["default"],
            scope=d["scope"], help=d.get("help", ""),
        )


def _mesh_axis_domain() -> Tuple[int, ...]:
    """Finite per-axis domain for the mesh-shape knobs: 0 (= auto) plus the
    powers of two up to the local device count: ``torch.cuda.device_count()``
    with a card, else 8 (the JAX package's value before any backend
    starts)."""
    n = 8
    try:
        import torch

        if torch.cuda.is_available():
            n = torch.cuda.device_count()
    except Exception:
        pass
    dom, p = [0], 1
    while p <= n:
        dom.append(p)
        p *= 2
    return tuple(dom)


KNOBS: Tuple[Knob, ...] = (
    Knob(
        name="bucket_min", env="DL4J_TPU_BUCKET_MIN", kind="int",
        domain=(1, 4, 8), default=1, scope="both",
        help="smallest rung of the geometric bucket ladder",
    ),
    Knob(
        name="bucket_growth", env="DL4J_TPU_BUCKET_GROWTH", kind="float",
        domain=(1.5, 2.0, 4.0), default=2.0, scope="both",
        help="bucket-ladder growth factor (fewer, coarser rungs when large)",
    ),
    Knob(
        name="chain_steps", env="DL4J_TPU_CHAIN_STEPS", kind="str",
        domain=("auto", "0", "4", "8", "16"), default="auto", scope="fit",
        help="chained-dispatch K: steps fused into one device dispatch",
    ),
    Knob(
        name="rnn_unroll", env="DL4J_TPU_RNN_UNROLL", kind="int",
        domain=(1, 4, 8, 16), default=8, scope="both",
        help="lax.scan unroll factor for recurrent layers",
    ),
    Knob(
        name="flash_block_q", env="DL4J_TPU_FLASH_BLOCK_Q", kind="int",
        domain=(64, 128, 256), default=128, scope="both",
        help="flash-attention query block size",
    ),
    Knob(
        name="flash_block_k", env="DL4J_TPU_FLASH_BLOCK_K", kind="int",
        domain=(64, 128, 256), default=128, scope="both",
        help="flash-attention key/value block size",
    ),
    Knob(
        name="compress_threshold", env="DL4J_TPU_COMPRESS_THRESHOLD",
        kind="float", domain=(1e-4, 1e-3, 1e-2), default=1e-3, scope="fit",
        help="gradient-compression residual threshold (DP exchange)",
    ),
    Knob(
        name="grad_accum", env="DL4J_TPU_GRAD_ACCUM", kind="int",
        domain=(1, 2, 4, 8), default=1, scope="fit",
        help="gradient-accumulation micro-batches per optimizer step "
             "(lax.scan inside the donated step; 1/A activation footprint)",
    ),
    Knob(
        name="mesh_data", env="DL4J_TPU_MESH_DATA", kind="int",
        domain=_mesh_axis_domain(), default=0, scope="fit",
        help="mesh data-axis size for the named-mesh step "
             "(parallel/mesh_step.py; 0 = auto: all devices left over after "
             "the model/pipe axes)",
    ),
    Knob(
        name="mesh_model", env="DL4J_TPU_MESH_MODEL", kind="int",
        domain=_mesh_axis_domain(), default=0, scope="fit",
        help="mesh tensor-parallel axis size (Megatron TP rules, "
             "parallel/tp.py; 0 = 1 = off)",
    ),
    Knob(
        name="mesh_pipe", env="DL4J_TPU_MESH_PIPE", kind="int",
        domain=_mesh_axis_domain(), default=0, scope="fit",
        help="mesh stage-axis size: carries the cross-replica sharded "
             "weight update in the unified step (arXiv 2004.13336) and the "
             "gpipe stage compute (0 = 1 = off)",
    ),
    Knob(
        name="kv_page_tokens", env="DL4J_TPU_KV_PAGE_TOKENS", kind="int",
        domain=(16, 32, 64, 128), default=64, scope="serve",
        help="KV-cache page size in tokens (decode engine, nn/decode.py): "
             "small pages waste less cache on short streams, large pages "
             "gather fewer indices per decode step",
    ),
    Knob(
        name="decode_batch_max", env="DL4J_TPU_DECODE_BATCH_MAX", kind="int",
        domain=(4, 8, 16, 32), default=8, scope="serve",
        help="token-level continuous-batching width cap: tokens/s rises "
             "with width until the padded decode step's ITL breaks the "
             "stream SLO",
    ),
    Knob(
        name="ivf_nlist", env="DL4J_TPU_IVF_NLIST", kind="int",
        domain=(0, 64, 128, 256, 512), default=0, scope="serve",
        help="IVF coarse-quantizer cell count (0 = auto ~ sqrt(n), bucket-"
             "rounded): more cells shrink each probed posting list but cost "
             "recall at fixed nprobe; acts at index BUILD time",
    ),
    Knob(
        name="ivf_nprobe", env="DL4J_TPU_IVF_NPROBE", kind="int",
        domain=(4, 8, 16, 32), default=8, scope="serve",
        help="IVF cells scanned per query: the recall/latency dial — "
             "candidates scanned grow linearly with nprobe while recall "
             "saturates; acts at index BUILD time (fixes the warmed grid)",
    ),
    Knob(
        name="search_batch_max", env="DL4J_TPU_SEARCH_BATCH_MAX", kind="int",
        domain=(8, 16, 32, 64), default=32, scope="serve",
        help="query-coalescing width cap for /v1/search: wider batches "
             "amortize kernel launches until the padded top-k step blows "
             "the per-request deadline",
    ),
)

_BY_NAME: Dict[str, Knob] = {k.name: k for k in KNOBS}

# knobs whose variable nothing in the port reads, and why
INERT: Dict[str, str] = {
    "flash_block_q": "a Pallas block size; the port's flash kernels fix their tiles "
                     "at build time (csrc/flash_fwd.cu, flash_bwd.cu)",
    "flash_block_k": "a Pallas block size; the port's flash kernels fix their tiles "
                     "at build time (csrc/flash_fwd.cu, flash_bwd.cu)",
    "rnn_unroll": "a lax.scan unroll factor; the port's recurrences run as one "
                  "fused-LSTM launch or a plain step loop",
}


def get(name: str) -> Optional[Knob]:
    return _BY_NAME.get(name)


def all_knobs(scope: Optional[str] = None) -> Tuple[Knob, ...]:
    if scope is None:
        return KNOBS
    return tuple(k for k in KNOBS if k.applies_to(scope))


def registry_dict() -> Dict[str, Dict[str, Any]]:
    """Full registry as plain dicts (recorded into every DB entry so a
    reader can interpret knob names without importing this module's exact
    revision)."""
    return {k.name: k.to_dict() for k in KNOBS}
