"""Point-to-plane ICP, fixed iterations, batched over scan pairs.

Behavioral contract (pseudo_label_generator/3d/scripts/loader.py:3902-3921,
icp_point_to_plane_open3d): open3d TransformationEstimationPointToPlane with
max_correspondence_distance 1.0, used by the optional ICP transformation
refinement (calculate_transformationsV2 :1016-1301, off by default:
use_icp False).

Counterpart of the JAX package's ``ops/icp.py``: ``num_iters``
Gauss-Newton steps and no early stop; correspondences from the full
pairwise squared distances (``ops/tfl.pairwise_sq_dists``); target
normals by k-NN PCA, the covariance's eigenvector in closed form on the
points' device.
Every function takes a leading pair dimension, so
``icp_batch`` is one call for a stack of pairs (the JAX ``vmap``); the
loop makes no host sync: the 6x6 solve is ``torch.linalg.solve_ex``
(no error check), and the re-orthogonalisation of the first-order rotation
is its polar factor in closed form.
"""

from __future__ import annotations

from typing import Tuple

import math

import torch

from monosowa_tpu_torch.ops.tfl import pairwise_sq_dists

BIG = 1e9

# elements of a chunk's (pairs, N, N) distance tensor in icp_batch
_PAIR_CHUNK_ELEMS = 1 << 27


def knn_indices(d2: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N, M) non-negative float32 distances -> (..., N, k) indices of
    the k smallest in ascending order, the lower index first among equal
    distances, as ``jax.lax.top_k(-d2, k)`` orders them.  The key is the
    distance's bits (monotone for non-negative floats) above the column
    index, unique per row (``torch.topk`` promises no order on ties)."""
    m = d2.shape[-1]
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    key = bits * m + torch.arange(m, device=d2.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 3) unit eigenvector of the smallest
    eigenvalue, in float64 and cast back, elementwise on the tensor's
    device.  The eigenvalue is the trigonometric root of the
    characteristic cubic; the vector is the longest cross product of two
    rows of cov - lambda I (each row is orthogonal to it).  Where every
    eigenvalue is equal, e0, the first column of ``eigh``'s identity."""
    c = cov.double()
    a00, a11, a22 = c[..., 0, 0], c[..., 1, 1], c[..., 2, 2]
    a01, a02, a12 = c[..., 0, 1], c[..., 0, 2], c[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22
                    + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = (det / (2.0 * p.clamp_min(1e-300) ** 3)).clamp(-1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.acos(r) / 3.0 + 2.0 * math.pi / 3.0)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    m = c - lam[..., None, None] * eye
    crosses = torch.stack([torch.linalg.cross(m[..., 0, :], m[..., 1, :]),
                           torch.linalg.cross(m[..., 0, :], m[..., 2, :]),
                           torch.linalg.cross(m[..., 1, :], m[..., 2, :])],
                          -2)                               # (..., 3, 3)
    norms = torch.linalg.vector_norm(crosses, dim=-1)
    best = norms.argmax(-1, keepdim=True)
    vec = torch.take_along_dim(crosses, best[..., None], -2)[..., 0, :]
    top = torch.take_along_dim(norms, best, -1)
    vec = torch.where(top > 0, vec / top.clamp_min(1e-300), eye[0])
    return vec.to(cov.dtype)


def neighbour_covariance(pts: torch.Tensor, mask: torch.Tensor,
                         k: int = 10) -> torch.Tensor:
    """(B, N, 3), (B, N) -> (B, N, 3, 3): the covariance of each point's k
    nearest valid points, the point itself among them."""
    d2 = pairwise_sq_dists(pts, pts)
    d2.masked_fill_(~mask.bool()[:, None, :], BIG)
    idx = knn_indices(d2, k)                                # (B, N, k)
    del d2
    rows = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
    nbrs = pts[rows, idx]                                   # (B, N, k, 3)
    centered = nbrs - nbrs.mean(-2, keepdim=True)
    return centered.transpose(-1, -2) @ centered / pts.new_tensor(float(k))


def estimate_normals(pts: torch.Tensor, mask: torch.Tensor,
                     k: int = 10) -> torch.Tensor:
    """(N, 3), (N,) or (B, N, 3), (B, N) -> unit normals of the same shape,
    by k-NN PCA: the eigenvector of the smallest eigenvalue of
    ``neighbour_covariance``.

    An eigenvector's sign is free: the JAX package's ``eigh`` and the
    closed form may pick either.  The ICP step does not depend on it: with n flipped, the
    Jacobian row [p x n, n] and the residual (p - q) . n both flip, and
    A = sum w j j^T and b = -sum w j r do not change."""
    if pts.dim() == 2:
        return estimate_normals(pts[None], mask[None], k)[0]
    return smallest_eigenvector(neighbour_covariance(pts, mask, k))


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [wx, wy, wz, tx, ty, tz] -> (..., 4, 4): the first-order
    rotation I + [w]x re-orthogonalised, then the translation.

    The JAX package takes the polar factor u @ vt of the matrix's SVD,
    which is unique.  For M = I + [w]x, M^T M = (1 + |w|^2) I - w w^T, so
    the polar factor is c I + w w^T / (s (s + 1)) + c [w]x with
    s = sqrt(1 + |w|^2) and c = 1 / s: the rotation about w by atan |w|."""
    w, t = xi[..., :3], xi[..., 3:]
    s = torch.sqrt(1.0 + (w * w).sum(-1))[..., None, None]
    c = 1.0 / s
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    skew = torch.stack([torch.stack([zero, -wz, wy], -1),
                        torch.stack([wz, zero, -wx], -1),
                        torch.stack([-wy, wx, zero], -1)], -2)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    rot = c * eye3 + w[..., :, None] * w[..., None, :] / (s * (s + 1.0)) \
        + c * skew
    out = torch.zeros(*xi.shape[:-1], 4, 4, dtype=xi.dtype,
                      device=xi.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _nearest(src: torch.Tensor, target: torch.Tensor,
             target_mask: torch.Tensor):
    """Nearest valid target point of each source point: (values, indices),
    each (B, N); the first minimum on ties, as ``jnp.argmin``."""
    d2 = pairwise_sq_dists(src, target)
    d2.masked_fill_(~target_mask[:, None, :], BIG)
    return d2.min(-1)


def _icp(source: torch.Tensor, source_mask: torch.Tensor,
         target: torch.Tensor, target_mask: torch.Tensor, max_dist: float,
         num_iters: int, normal_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs (B, N, 3) -> (T (B, 4, 4), rms (B,)); one batch, no chunking."""
    b = source.shape[0]
    normals = estimate_normals(target, target_mask, normal_k)
    dev, dt = source.device, source.dtype
    tmat = torch.eye(4, dtype=dt, device=dev).repeat(b, 1, 1)
    rms = source.new_zeros(b)
    max_d2 = source.new_tensor(max_dist * max_dist)
    ridge = 1e-6 * torch.eye(6, dtype=dt, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for _ in range(num_iters):
        src = source @ tmat[:, :3, :3].transpose(-1, -2) \
            + tmat[:, None, :3, 3]
        nn_d2, nn = _nearest(src, target, target_mask)
        w = (source_mask & (nn_d2 < max_d2)).to(dt)
        q = target[rows, nn]
        n = normals[rows, nn]
        r = ((src - q) * n).sum(-1)                        # (B, N)
        jac = torch.cat([torch.linalg.cross(src, n, dim=-1), n], -1)
        a = (jac * w[..., None]).transpose(-1, -2) @ jac + ridge
        rhs = -((jac * (r * w)[..., None]).sum(-2))
        xi = torch.linalg.solve_ex(a, rhs)[0]
        rms = torch.sqrt((w * r * r).sum(-1) / w.sum(-1).clamp_min(1.0))
        tmat = _se3_exp(xi) @ tmat
    return tmat, rms


def icp_point_to_plane(source: torch.Tensor, source_mask: torch.Tensor,
                       target: torch.Tensor, target_mask: torch.Tensor,
                       max_dist: float = 1.0, num_iters: int = 20,
                       normal_k: int = 10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (T 4x4 mapping source -> target, final rms residual).

    source (N, 3), source_mask (N,) bool, target (M, 3), target_mask (M,):
    padded point sets; the rms is the residual of the last iteration's
    correspondences (before its update), as in the JAX package."""
    t, rms = icp_batch(source[None], source_mask[None], target[None],
                       target_mask[None], max_dist, num_iters, normal_k)
    return t[0], rms[0]


def icp_batch(source: torch.Tensor, source_mask: torch.Tensor,
              target: torch.Tensor, target_mask: torch.Tensor,
              max_dist: float = 1.0, num_iters: int = 20,
              normal_k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICP over (B, N, 3) source / target stacks -> ((B, 4, 4), (B,)): the
    JAX ``vmap`` of ``icp_point_to_plane``, in chunks of pairs whose
    (pairs, N, M) distance tensor holds at most 2^27 elements."""
    b, n = source.shape[:2]
    chunk = max(1, _PAIR_CHUNK_ELEMS // max(n * target.shape[1], 1))
    source_mask, target_mask = source_mask.bool(), target_mask.bool()
    outs = [_icp(source[i:i + chunk], source_mask[i:i + chunk],
                 target[i:i + chunk], target_mask[i:i + chunk], max_dist,
                 num_iters, normal_k) for i in range(0, b, chunk)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))
