"""normal_cloud_roofline (%; kernels: ops/neighbors.py →
csrc/neighbors.cu): the least time of the window's dynamic-normal clouds
(`rooflines/normal_cloud.py`), over the device time of `normal_cloud` in
the traced window."""


def read(run):
    return run.roofline_pct("normal_cloud")
