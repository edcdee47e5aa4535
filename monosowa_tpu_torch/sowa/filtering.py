"""Outlier-removal ensemble, in torch.

Behavioral contract (pseudo_label_generator/3d/scripts/loader.py:4072-4132,
ensamble_clustering): five detectors vote on standardized points; a point is
dropped when >= ensamble_threshold (2) flag it:

1. z-score: max per-axis |z| > 3;
2. HBOS (pyod): histogram-based outlier score;
3. open3d statistical outlier removal: mean 200-NN distance beyond
   mean + 1.0 std of that statistic;
4. HDBSCAN noise; 5. DBSCAN(eps=0.2, min_samples=10) noise.

Counterpart of the JAX package's ``sowa/filtering.py``, with the same
decision semantics: z-score exact; HBOS via fixed-bin per-axis histograms
(density rank-scored at the contamination quantile, pyod's default 0.1);
SOR exact via top-k over the distance matrix; DBSCAN noise exact (a point
is noise iff no core point within eps, computed from the neighbor-count
matrix); HDBSCAN exact via ``hdbscan_np`` in the host ensemble
(``ensemble_inlier_mask_host``, the pipeline's).  ``ensemble_inlier_mask``
keeps the JAX package's fixed-shape variant, a second DBSCAN in place of
the HDBSCAN vote.

All functions are mask-aware and fixed-shape (they return refined masks):
pts (N, 3) float32, mask (N,) bool tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from monosowa_tpu_torch.ops.tfl import pairwise_sq_dists

BIG = 1e9


def _count(mask: torch.Tensor) -> torch.Tensor:
    """max(sum(mask), 1) as float32."""
    return mask.sum().clamp_min(1).to(torch.float32)


def _standardize(pts, mask):
    n = _count(mask)
    mean = torch.where(mask[:, None], pts, 0.0).sum(0) / n
    var = torch.where(mask[:, None], (pts - mean) ** 2, 0.0).sum(0) / n
    return (pts - mean) / torch.sqrt(var + 1e-9)


def zscore_outliers(pts, mask, threshold: float = 3.0):
    z = _standardize(pts, mask)
    z = _standardize(z, mask).abs()  # the reference standardizes twice
    return (z.amax(1) > threshold) & mask


def hbos_outliers(pts, mask, n_bins: int = 10, contamination: float = 0.1):
    """Per-axis histogram density score; top ``contamination`` fraction
    flagged (pyod HBOS defaults)."""
    z = _standardize(pts, mask)
    big = pts.new_full((), BIG)
    n = _count(mask)
    score = pts.new_zeros(pts.shape[0])
    for axis in range(3):
        v = z[:, axis]
        lo = torch.where(mask, v, big).amin()
        hi = torch.where(mask, v, -big).amax()
        width = (hi - lo).clamp_min(1e-6) / pts.new_full((), float(n_bins))
        idx = ((v - lo) / width).long().clamp(0, n_bins - 1)
        counts = pts.new_zeros(n_bins).index_add_(0, idx, mask.to(pts.dtype))
        dens = counts[idx] / n
        score = score + (-torch.log(dens + 1e-9))
    score = torch.where(mask, score, -big)
    k = (n * pts.new_full((), contamination)).long().clamp_min(1)
    srt = torch.sort(score, descending=True).values
    thresh = srt[torch.clamp(k - 1, max=score.shape[0] - 1)]
    return (score >= thresh) & mask


def sor_outliers(pts, mask, nb_neighbors: int = 200, std_ratio: float = 1.0):
    """Statistical outlier removal (open3d semantics)."""
    d2 = pairwise_sq_dists(pts, pts)
    d2 = torch.where(mask[None, :], d2, d2.new_full((), BIG))
    d2 = d2 + torch.eye(pts.shape[0], dtype=d2.dtype,
                        device=d2.device) * BIG
    k = min(nb_neighbors, pts.shape[0] - 1)
    nn = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
    mean_d = torch.sqrt(nn.clamp_min(0.0)).mean(1)
    n = _count(mask)
    mu = torch.where(mask, mean_d, 0.0).sum() / n
    sd = torch.sqrt(torch.where(mask, (mean_d - mu) ** 2, 0.0).sum() / n)
    return (mean_d > mu + std_ratio * sd) & mask


def dbscan_noise(pts, mask, eps: float = 0.2, min_samples: int = 10):
    """Noise flag: not within eps of any core point (standardized space)."""
    z = _standardize(pts, mask)
    d2 = pairwise_sq_dists(z, z)
    within = (d2 <= float(np.float32(eps * eps))) & mask[None, :] \
        & mask[:, None]
    n_nbr = within.sum(1)                               # includes self
    core = (n_nbr >= min_samples) & mask
    reachable = (within & core[None, :]).any(1)
    return (~reachable) & mask


def ensemble_inlier_mask(pts: torch.Tensor, mask: torch.Tensor,
                         threshold: int = 2) -> torch.Tensor:
    """Refined validity mask after the 5-vote ensemble (the second DBSCAN
    stands in for HDBSCAN)."""
    mask = mask.bool()
    votes = (zscore_outliers(pts, mask).int()
             + hbos_outliers(pts, mask).int()
             + sor_outliers(pts, mask).int()
             + dbscan_noise(pts, mask, eps=0.2).int()
             + dbscan_noise(pts, mask, eps=0.45, min_samples=5).int())
    keep = mask & (votes < threshold)
    # degenerate guard: if everything got flagged, keep the original mask
    return torch.where(keep.any(), keep, mask)


def _four_votes(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Vote counts from the four detectors that are fixed-shape tensor
    work."""
    return (zscore_outliers(pts, mask).int()
            + hbos_outliers(pts, mask).int()
            + sor_outliers(pts, mask).int()
            + dbscan_noise(pts, mask, eps=0.2).int())


def ensemble_inlier_mask_host(pts, threshold: int = 2, device=None):
    """Exact five-voter ensemble: four votes on ``device`` (None: the
    card) + exact HDBSCAN noise on the host.

    The reference's loader.py:4112-4115 uses ``hdbscan.HDBSCAN()``
    defaults on the standardized cloud.  As in the JAX package, the four
    votes see the points in float32 and the HDBSCAN z-score is float64.
    Returns a boolean keep-mask over the dense (unpadded) input points
    (numpy).
    """
    from monosowa_tpu_torch.device import resolve_device
    from monosowa_tpu_torch.sowa.hdbscan_np import hdbscan_noise

    pts = np.asarray(pts, dtype=np.float64)
    n = pts.shape[0]
    if n <= 3:  # reference guard, loader.py:4074-4075
        return np.ones(n, dtype=bool)
    dev = resolve_device(device)
    votes = _four_votes(
        torch.as_tensor(pts.astype(np.float32), device=dev),
        torch.ones(n, dtype=torch.bool, device=dev)).cpu().numpy()
    z = (pts - pts.mean(0)) / np.sqrt(pts.var(0) + 1e-9)
    votes = votes + hdbscan_noise(z)
    keep = votes < threshold
    return keep if keep.any() else np.ones(n, dtype=bool)
