"""UI server CLI: ``python -m deeplearning4j_tpu_torch.ui``.

Reference parity: deeplearning4j-ui-parent play/PlayUIServer.java:3-14 (the
standalone dashboard process with a port flag). Attaches a durable JSONL
StatsStorage written by a training run's StatsListener and serves the
dashboard.

Example::

    python -m deeplearning4j_tpu_torch.ui --storage runs/stats.jsonl --port 9001
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.ui",
        description="Serve the training dashboard from a stats-storage file.")
    p.add_argument("--storage", required=True,
                   help="JSONL stats file written by FileStatsStorage")
    p.add_argument("--port", type=int, default=9001)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.storage import FileStatsStorage

    ui = UIServer.get_instance()
    ui.attach(FileStatsStorage(args.storage))
    ui.serve(args.port)
    print(f"UI server on port {ui.port}", flush=True)
    try:
        import threading
        threading.Event().wait()
    except KeyboardInterrupt:
        ui.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
