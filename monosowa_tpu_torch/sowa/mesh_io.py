"""Dependency-free mesh IO: glTF 2.0 (embedded-buffer) and OBJ loading,
plus area-weighted surface sampling.

The reference builds its template library from 4 car CAD meshes with
open3d (loader.py:3465-3840: read gltf, center, rotate zxy, anisotropic
scale to template dims, sample_points_uniformly(1000)).  open3d is not a
dependency here; glTF is just JSON + typed buffers, so this module parses it
with numpy directly and `TemplateBank.from_gltf` (sowa/templates.py)
reproduces the reference's sampling semantics.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    data = buffers[view.get("buffer", 0)]
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        rows = []
        for i in range(count):
            start = offset + i * stride
            rows.append(np.frombuffer(data, dtype, ncomp, start))
        arr = np.stack(rows)
    else:
        arr = np.frombuffer(data, dtype, count * ncomp, offset)
        arr = arr.reshape(count, ncomp)
    return arr.copy()


def _quat_to_matrix(q) -> np.ndarray:
    """glTF quaternion [x, y, z, w] -> 3x3 rotation."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "rotation" in node:
        m[:3, :3] = _quat_to_matrix(node["rotation"])
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"])[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_gltf(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """glTF 2.0 -> (vertices (V, 3) float64, faces (F, 3) int64), scene
    node transforms applied (flat or hierarchical)."""
    with open(path) as f:
        doc = json.load(f)
    buffers = _load_buffers(doc, os.path.dirname(os.path.abspath(path)))
    verts: List[np.ndarray] = []
    faces: List[np.ndarray] = []
    base = 0

    def visit(node_idx: int, parent: np.ndarray):
        nonlocal base
        node = doc["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if "POSITION" not in prim.get("attributes", {}):
                    continue
                v = _read_accessor(doc, buffers,
                                   prim["attributes"]["POSITION"]) \
                    .astype(np.float64)
                v = v @ m[:3, :3].T + m[:3, 3]
                if "indices" in prim:
                    f_idx = _read_accessor(
                        doc, buffers, prim["indices"]).reshape(-1, 3)
                else:
                    f_idx = np.arange(len(v)).reshape(-1, 3)
                verts.append(v)
                faces.append(f_idx.astype(np.int64) + base)
                base += len(v)
        for child in node.get("children", []):
            visit(child, m)

    scene = doc["scenes"][doc.get("scene", 0)]
    for n in scene["nodes"]:
        visit(n, np.eye(4))
    if not verts:
        raise ValueError(f"no mesh primitives in {path}")
    return np.concatenate(verts), np.concatenate(faces)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Wavefront OBJ -> (vertices, triangle faces); fans polygons."""
    vs: List[List[float]] = []
    fs: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1
                       for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    fs.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(vs, np.float64), np.asarray(fs, np.int64)


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        n_points: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling
    (open3d sample_points_uniformly semantics)."""
    rng = np.random.default_rng(seed)
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh")
    tri = rng.choice(len(faces), size=n_points, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=n_points))[:, None]
    r2 = rng.uniform(size=n_points)[:, None]
    return ((1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri])


def rotation_zxy(z: float, x: float, y: float) -> np.ndarray:
    """open3d get_rotation_matrix_from_zxy: Rz @ Rx @ Ry."""
    cz, sz = np.cos(z), np.sin(z)
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return rz @ rx @ ry
