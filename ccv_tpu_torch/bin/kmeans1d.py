"""bin/kmeans1d twin on the PyTorch port: a micro-benchmark of the exact
1-D k-means (reference: bin/kmeans1d.c, 1M uniform points into 128
clusters).

    python -m ccv_tpu_torch.bin.kmeans1d [n] [k]

Draws n float32 points from ``np.random.default_rng(0)`` as bin/kmeans1d.py
does, clusters them with ``core.numeric.kmeans1d`` (host numpy, as
``ccv_tpu``'s) and prints "elapsed: <ms>ms", a host time: no device.
"""

import sys
import time

import numpy as np


def run(n: int = 1_000_000, k: int = 128):
    """(clusters, centroids, elapsed ms) of the tool's draw."""
    from ccv_tpu_torch.core.numeric import kmeans1d

    a = np.random.default_rng(0).uniform(0.0, 1.0, n).astype(np.float32)
    t0 = time.perf_counter()
    clusters, centroids = kmeans1d(a, k)
    return clusters, centroids, (time.perf_counter() - t0) * 1000


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    k = int(argv[1]) if len(argv) > 1 else 128
    _, centroids, elapsed = run(n, k)
    if len(centroids) != k:
        raise RuntimeError(f"{len(centroids)} centroids for k {k}")
    print(f"elapsed: {elapsed:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
