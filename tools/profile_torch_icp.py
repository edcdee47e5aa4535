"""The ICP normals' eigensolver on one GPU, by each route.

On a seeded batch of 8 pairs of 4,096 points (a ground plane, two walls and
box faces, 1 cm noise; the second cloud moved by 0.3 m and 1 degree), on
``cuda``:

* tries ``torch.linalg.eigh`` (cuSOLVER) on the 8 x 4,096 neighbour
  covariances of ``ops/icp.py`` ``neighbour_covariance`` at once, and on the
  32,768 matrices flattened in batches of 1,024 to 32,768; prints each
  batch's time (CUDA events) or the error it raised;
* times three routes from the covariances to the normals: the copy to the
  host, LAPACK's ``eigh`` there and the copy back; cuSOLVER in the largest
  batch that ran; ``ops/icp.py`` ``smallest_eigenvector`` (closed form,
  float64, on the card); and prints how far each route's normals are from
  LAPACK's float64 ``eigh`` (1 - |cos| of the angle, the largest);
* times ``icp_batch`` over the 8 pairs (20 steps, k = 10) with the closed
  form and with the host route in its place, in this one process.

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_icp.py
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAIRS, POINTS = 8, 4096


def event_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clouds(seed: int = 0):
    """(PAIRS, POINTS, 3) float32 sources and targets: points on a ground
    plane, two walls and the faces of 12 boxes, with 1 cm noise; each
    target the source moved by 0.3 m and 1 degree about the vertical."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = np.zeros((PAIRS, POINTS, 3))
    for b in range(PAIRS):
        face = rng.integers(0, 4, POINTS)
        u, v = rng.uniform(0, 1, (2, POINTS))
        pts = np.stack([40 * u - 20, np.full(POINTS, 1.65), 60 * v], 1)
        wall = face == 1
        pts[wall] = np.stack([np.where(u[wall] < 0.5, -12.0, 12.0),
                              1.65 - 8 * v[wall], 60 * u[wall]], 1)
        box = face >= 2
        k = rng.integers(0, 12, box.sum())
        cx, cz = rng.uniform(-8, 8, 12)[k], rng.uniform(5, 50, 12)[k]
        side = rng.integers(0, 2, box.sum())
        pts[box] = np.stack([cx + np.where(side == 0, 1.8 * u[box] - 0.9,
                                           0.9),
                             1.65 - 1.5 * v[box],
                             cz + np.where(side == 0, -2.1,
                                           4.2 * u[box] - 2.1)], 1)
        src[b] = pts + rng.normal(scale=0.01, size=pts.shape)
    c, s = np.cos(np.deg2rad(1.0)), np.sin(np.deg2rad(1.0))
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    tgt = src @ rot.T + [0.3, 0.0, 0.2]
    return src.astype(np.float32), tgt.astype(np.float32)


def host_eigenvector(cov):
    """The route the normals took before: LAPACK's eigh on the host."""
    import torch

    _, vecs = torch.linalg.eigh(cov.cpu())
    normals = vecs[..., :, 0].to(cov.device)
    return normals / torch.linalg.vector_norm(
        normals, dim=-1, keepdim=True).clamp_min(1e-9)


def main() -> int:
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import icp

    if not torch.cuda.is_available():
        print("profile_torch_icp: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    src_np, tgt_np = clouds()
    src, tgt = torch.from_numpy(src_np).to(dev), torch.from_numpy(tgt_np).to(dev)
    mask = torch.ones(PAIRS, POINTS, dtype=torch.bool, device=dev)
    cov = icp.neighbour_covariance(tgt, mask)
    torch.cuda.synchronize()

    # cuSOLVER at the batch's shape and in flattened batches
    tries = {}
    shapes = {"8 x 4096": cov}
    flat = cov.reshape(-1, 3, 3)
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        shapes[f"{n}"] = flat[:n]
    largest = None
    for name, c in shapes.items():
        try:
            ms = event_ms(lambda: torch.linalg.eigh(c))
            tries[name] = {"ms": ms}
            if c.dim() == 3:
                largest = c.shape[0]
        except RuntimeError as err:
            tries[name] = {"error": str(err).splitlines()[0][:300]}
            torch.cuda.synchronize()
    print(json.dumps({"part": "cusolver eigh", "batches": tries}), flush=True)

    # the routes, and their normals against float64 LAPACK
    want = torch.linalg.eigh(cov.double().cpu())[1][..., :, 0]
    routes = {"host lapack (before)": host_eigenvector,
              "closed form on the card": icp.smallest_eigenvector}
    if largest:
        def chunked(c):
            f = c.reshape(-1, 3, 3)
            vecs = torch.cat([torch.linalg.eigh(f[i:i + largest])[1]
                              for i in range(0, f.shape[0], largest)])
            return vecs[..., :, 0].reshape(c.shape[:-1])
        routes[f"cusolver in batches of {largest}"] = chunked
    out = {}
    for name, fn in routes.items():
        got = fn(cov).double().cpu()
        cos = (got * want).sum(-1).abs()
        out[name] = {"ms": event_ms(lambda: fn(cov)),
                     "max_one_minus_abs_cos": float((1 - cos).max())}
    print(json.dumps({"part": "normals", "matrices": PAIRS * POINTS,
                      "routes": out}), flush=True)

    # a batch of pairs, closed form and host route
    times = {}
    closed = icp.smallest_eigenvector
    for name, fn in (("closed form", closed), ("host lapack", host_eigenvector),
                     ("closed form again", closed)):
        icp.smallest_eigenvector = fn
        try:
            times[name] = event_ms(lambda: icp.icp_batch(src, mask, tgt, mask),
                                   iters=3, warmup=1) / PAIRS
        finally:
            icp.smallest_eigenvector = closed
    t, rms = icp.icp_batch(src, mask, tgt, mask)
    print(json.dumps({"part": "icp_batch", "pairs": PAIRS, "points": POINTS,
                      "ms_per_pair": times,
                      "rms": [float(r) for r in rms.cpu()],
                      "finite": bool(torch.isfinite(t).all())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
