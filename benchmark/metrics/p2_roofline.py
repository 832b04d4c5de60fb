"""p2_roofline (%; kernels: ops/p2.py → csrc/p2.cu): the least time of
the window's P2 work on the card (`rooflines/p2.py`), over the device
time of the P2 kernel in the traced window."""


def read(run):
    return run.roofline_pct("p2")
