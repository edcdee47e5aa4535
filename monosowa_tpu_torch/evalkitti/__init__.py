"""KITTI AP evaluation stack (numpy, a native C++ library, torch rotated
IoU as the oracle).

Rebuild of the reference's numba AP implementation
(pseudo_label_generator/3d/eval/kitti_eval_python/eval.py and the identical
copy under MonoDETR), the correctness-critical metric definition; the torch
port's counterpart of the JAX package's ``evalkitti``.
"""

from monosowa_tpu_torch.evalkitti.eval import (  # noqa: F401
    annos_from_label_dir, clean_data, eval_class, get_distance_eval_result,
    get_official_eval_result, get_thresholds, image_box_overlap)
