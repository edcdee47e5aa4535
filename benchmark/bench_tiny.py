"""Tiny versions of the cells for the benchmark's CPU tests: the same
widths, small images, a small batch and split."""

TRAIN = {
    "config": {"dataset_update": {"resolution": [256, 80], "batch_size": 2}},
    "traffic": {"split_images": 40, "distinct_images": 4,
                "frame_hw": [77, 248],
                "calib_p2": [144.3, 0, 121.9, 8.97, 0, 144.3, 34.57, 0.0433,
                             0, 0, 1, 0.0027],
                "near_depth_m": [4.0, 20.0], "far_depth_m": [10.0, 16.0],
                "trace_skip": 1, "trace_units": 1, "trace_gap_units": 1},
}
MASKS = {
    "config": {"input_hw": [64, 128]},
    "traffic": {"frame_hw": [60, 124], "distinct_frames": 3,
                "warm_frames": 1, "check_within": 2, "check_frames": 2,
                "trace_skip": 1, "trace_units": 1, "trace_gap_units": 1},
}


# label files of clear Cars alone, then DontCare rows: the rows on which the
# port's matching agrees with the reference's (PERF.md, Open questions)
KEPT_CARS_ONLY = {"car_states": {"occluded": 0.0, "far": 0.0,
                                 "truncated": 0.0, "hidden": 0.0},
                  "others_per_image": {}}


def overrides(bench, cell_name: str, fault=None, kept_cars_only=False
              ) -> dict:
    """``run.run_cell``'s overrides for the tiny version of a cell;
    ``kept_cars_only``: the train cell's label files hold clear Cars
    alone."""
    if cell_name.startswith("monodetr"):
        ds = dict(bench.config("monodetr-kitti")["dataset"],
                  **TRAIN["config"]["dataset_update"])
        traffic = dict(TRAIN["traffic"],
                       **(KEPT_CARS_ONLY if kept_cars_only else {}))
        return {"config": {"dataset": ds}, "traffic": traffic,
                "fault": fault}
    return {"config": dict(MASKS["config"]),
            "traffic": dict(MASKS["traffic"]), "fault": fault}
