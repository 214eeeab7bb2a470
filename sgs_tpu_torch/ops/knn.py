"""Mean squared distance to the 3 nearest neighbours: the initial scale of
each Gaussian built from a point cloud. Port of `sgs_tpu/ops/knn.py`.

Exact brute force over chunks of queries, in the same form as the JAX
version: d2 = |q|^2 + |p|^2 - 2 q.p with one float32 matrix product per
chunk (TF32 switched off for it), clamped at 0, and the k+1 smallest by
`topk` (the first is the point itself). `torch.cdist` is not used: its
default mode switches algorithm by size. Runs once per scene.
"""

from __future__ import annotations

import torch


def mean_sq_dist_knn(points: torch.Tensor, k: int = 3, chunk: int = 4096) -> torch.Tensor:
    """(N, 3) float32 -> (N,) mean squared distance to the k nearest other points."""
    pts = points.to(torch.float32)
    sq = torch.sum(pts * pts, dim=-1)
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, pts.shape[0], chunk):
            q = pts[s:s + chunk]
            dots = torch.matmul(q, pts.T)
            d2 = sq[s:s + chunk, None] + sq[None, :] - 2.0 * dots
            d2 = torch.clamp_min(d2, 0.0)
            smallest = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True).values
            out.append(torch.mean(smallest[:, 1:k + 1], dim=-1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out) if out else sq.new_zeros(0)


def mean_sq_dist_3nn(points: torch.Tensor) -> torch.Tensor:
    return mean_sq_dist_knn(points, k=3)
