"""Device-resident ANN search tier (PyTorch port of the JAX package's
``search/``).

The retrieval layer (reference: VPTree/KD-tree/LSH + the
NearestNeighborsServer): three matmul-shaped scoring tiers (exact / IVF /
IVF-PQ) over a fixed-shape device corpus, warmed per bucket rung and served
through the same admission/SLO machinery as every other route
(``serve/``: ``ModelRegistry.register_index``, ``POST /v1/search``).
"""

from deeplearning4j_tpu_torch.search.index import IndexConfig, VectorIndex
from deeplearning4j_tpu_torch.search.program import (
    SITE_EXACT, SITE_IVF, SITE_MERGE, SITE_PQ, SearchProgram,
)

__all__ = [
    "IndexConfig", "SITE_EXACT", "SITE_IVF", "SITE_MERGE", "SITE_PQ",
    "SearchProgram", "VectorIndex",
]
