"""Nearest-neighbours server CLI: ``python -m deeplearning4j_tpu_torch.clustering``.

The port of the JAX package's ``clustering/__main__.py`` (reference:
deeplearning4j-nearestneighbors-parent/nearestneighbor-server
NearestNeighborsServer.java, a flag-driven standalone HTTP kNN server).
It serves on the GPU unless ``--device cpu`` is given.

Example::

    python -m deeplearning4j_tpu_torch.clustering --points vectors.npy \
        --port 9000 --similarity euclidean
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.clustering",
        description="Serve k-nearest-neighbors queries over a point set.")
    p.add_argument("--points", required=True,
                   help=".npy [N,D] array or .npz with array 'points'")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--similarity", default="euclidean",
                   choices=["euclidean", "cosine", "manhattan", "dot"])
    p.add_argument("--invert", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run there)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer

    if args.points.endswith(".npz"):
        d = np.load(args.points)
        pts = d["points"] if "points" in d else d[d.files[0]]
    else:
        pts = np.load(args.points)
    srv = NearestNeighborsServer(pts, similarity_function=args.similarity,
                                 invert=args.invert,
                                 device=args.device).start(args.port)
    print(f"nearest-neighbors server on port {srv.port} "
          f"({pts.shape[0]} points, dim {pts.shape[1]})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
