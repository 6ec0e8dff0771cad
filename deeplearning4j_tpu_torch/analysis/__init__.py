"""graftlint for the port: static analysis of host/device boundaries, and
the runtime retrace and donation guards.

Counterpart of ``deeplearning4j_tpu/analysis/``. Bucketed dispatch
(``utils/bucketing.py``) only pays off while nothing adds a new signature
per call or drags device values back to the host mid-step; PyTorch hides
both as well as JAX does, so this package makes them visible:

- ``engine``         AST module index, call graph, the traced and hot sets,
                     in a dialect (``torch`` for the port, ``jax`` for the
                     JAX package's own tables)
- ``dataflow``       the interprocedural value layer (donations and in-place
                     steps, durable paths)
- ``rules`` / ``rules_distributed``  the twelve rules
- ``lint``           CLI: ``python -m deeplearning4j_tpu_torch.analysis.lint
                     deeplearning4j_tpu_torch`` against the checked-in
                     ``baseline.json``, so only new findings fail
- ``sarif``          SARIF 2.1.0 output
- ``retrace_guard``  runtime: new signatures per site against the bucket
                     ladder (``DL4J_TPU_RETRACE_GUARD``, ``DL4J_TPU_STRICT_RETRACE``)
- ``donation_guard`` runtime: an in-place step must keep every leaf it
                     took (``DL4J_TPU_DONATION_GUARD``)

Import-light: importing this package imports nothing; the lint modules use
only the standard library, and ``nn/model.py`` imports the guards.
"""

__all__ = ["engine", "dataflow", "rules", "rules_distributed", "lint", "sarif",
           "retrace_guard", "donation_guard"]
