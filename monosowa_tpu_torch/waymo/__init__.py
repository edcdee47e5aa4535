"""Native Waymo Open Dataset ingestion (no tensorflow / waymo_open_dataset),
the torch port's copy of the JAX package's ``waymo/``.

The wire schema the converter needs is transcribed in
``monosowa_torch_waymo.proto`` (the JAX package's schema under a file name
and proto package of its own, so that both register in protobuf's default
pool in one process) and compiled with ``protoc`` at first use of
``dataset_pb2``; ``frame_utils`` holds the public range-image ->
point-cloud math in numpy; ``tfrecord`` reads and writes the TFRecord
framing in pure Python.  Only ``dataset_pb2`` needs protobuf.

Reference consumer: pseudo_label_generator/waymo_to_kitti_projected.py:4-5
(``from waymo_open_dataset import dataset_pb2`` + ``frame_utils``).
"""

from __future__ import annotations

import importlib
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_PROTO = os.path.join(_HERE, "monosowa_torch_waymo.proto")
_GEN = os.path.join(_HERE, "monosowa_torch_waymo_pb2.py")


def _ensure_generated() -> None:
    """protoc-compile the schema if the generated module is missing or
    older than the .proto; the module is written to a temporary directory
    and moved into place, so that a process never reads half a file."""
    if (os.path.exists(_GEN)
            and os.path.getmtime(_GEN) >= os.path.getmtime(_PROTO)):
        return
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        subprocess.run(
            ["protoc", f"--proto_path={_HERE}", f"--python_out={tmp}",
             os.path.basename(_PROTO)],
            check=True, capture_output=True)
        os.replace(os.path.join(tmp, os.path.basename(_GEN)), _GEN)


def __getattr__(name: str):
    if name != "dataset_pb2":
        raise AttributeError(name)
    _ensure_generated()
    module = importlib.import_module(__name__ + ".monosowa_torch_waymo_pb2")
    globals()["dataset_pb2"] = module
    return module


__all__ = ["dataset_pb2"]
