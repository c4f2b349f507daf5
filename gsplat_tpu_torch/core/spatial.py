"""KNN distances for the scale initialisation.

Counterpart of `gsplat_tpu/core/spatial.py`: the reference initialises
log-scales from the mean squared distance to the 3 nearest neighbours,
computed by the `simple-knn` CUDA submodule (`scene/gaussian_model.py:
159-160`). Here a chunked brute-force search in plain torch: (chunk, N)
distance blocks from one float32 matmul each. Init-time only.
"""

from __future__ import annotations

import torch


def mean_knn_sq_dist(points, k: int = 3, chunk: int = 2048):
    """Mean squared distance from each point to its k nearest neighbours
    (self excluded); `simple_knn._C.distCUDA2` as used at init.

    Args:
      points: (N, 3) float32.
      k: neighbour count (3 in the reference).
      chunk: rows per distance block, at most; fewer where a (chunk, N)
        block would pass 2^26 floats (256 MiB).

    Returns:
      (N,) float32.
    """
    n = points.shape[0]
    chunk = max(1, min(chunk, (1 << 26) // max(n, 1)))
    sq_norms = torch.sum(points * points, dim=-1)  # (N,)
    out = []
    for i in range(0, n, chunk):
        c = points[i : i + chunk]
        # d2[i, j] = |ci|^2 - 2 ci.pj + |pj|^2 (float32 matmul, no TF32)
        d2 = torch.sum(c * c, dim=-1)[:, None] - 2.0 * (c @ points.T) + sq_norms[None, :]
        # the k+1 smallest: the ~0 self distance first, then the neighbours
        near = torch.topk(d2, min(k + 1, n), dim=1, largest=False).values
        out.append(torch.clamp(near[:, 1:], min=0.0).sum(dim=1) / k)
    return torch.cat(out) if out else points.new_zeros((0,))
