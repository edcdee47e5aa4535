"""The SOWA pseudo-label pipeline: auto-labelling of cars from monocular
video (point clouds and instance masks in, KITTI 3D car labels out)."""
