"""Byte-compatible KITTI-format IO: labels, calibration, OXTS ego poses.

This is the interface contract between the pseudo-label generator and the
detector (reference: pseudo_label_generator/3d/scripts/output.py:12-91 writes
label txt files that MonoDETR/lib/datasets/kitti/kitti_utils.py:6-116 parses).
"""

from monosowa_tpu_torch.kittiio.labels import (  # noqa: F401
    KittiObject,
    LabelSet,
    read_label_file,
    write_detection_file,
    write_pseudo_label_file,
    obj_level,
)
from monosowa_tpu_torch.kittiio.calib import (  # noqa: F401
    Calibration, read_calib_file)
from monosowa_tpu_torch.kittiio.oxts import (  # noqa: F401
    oxts_to_poses,
    read_oxts_file,
)
