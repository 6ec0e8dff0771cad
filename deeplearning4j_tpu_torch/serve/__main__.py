"""``python -m deeplearning4j_tpu_torch.serve name=path [name=path ...]``

The port of the JAX package's ``serve/__main__.py``: import each model
(Keras ``.h5`` or DL4J ``.zip``, format auto-detected, through
``ModelRegistry.load``), warm it over every batch bucket its worker can
coalesce, and serve them all from one port. The socket binds only after
every model is warm, so the first request pays no CUDA context set-up or
kernel build. The JAX package's ``<path>.aotbundle`` sidecars are not
ported (ROADMAP Queue 1 item 9).

Options: ``--port N`` (default 8000; 0 = OS-assigned, printed on stdout);
``--device`` (default: the GPU, raising without one; ``cpu`` serves there),
the trainer CLI's device flag.

Example::

    python -m deeplearning4j_tpu_torch.serve charrnn=model.zip --port 0
    # -> serving charrnn on http://127.0.0.1:<port>
    #    POST /v1/models/charrnn:predict
"""

from __future__ import annotations

import argparse
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serve",
        description="continuous-batching inference server")
    ap.add_argument("models", nargs="+", metavar="name=path",
                    help="model to serve: name=path/to/model.h5|.zip")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="device to serve on, e.g. cpu or cuda:1 (default: the GPU)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    specs = []
    for spec in args.models:
        name, _, path = spec.partition("=")
        if not name or not path:
            ap.error(f"expected name=path, got {spec!r}")
        specs.append((name, path))

    from deeplearning4j_tpu_torch.serve import InferenceServer, ModelRegistry

    registry = ModelRegistry(device=args.device)
    for name, path in specs:
        print(f"loading {name} from {path} ...", flush=True)
        registry.load(name, path)
    srv = InferenceServer(registry).start(port=args.port)
    print(f"serving {', '.join(registry.names())} on "
          f"http://127.0.0.1:{srv.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
