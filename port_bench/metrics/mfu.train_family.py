"""``mfu.train_family``: ``mfu.train`` for a family of ``families/``: the
family's model FLOPs of one image's train step (``families/<arch>.py::
train_flops``: every conv of forward, dw and dx, a weight-shared recurrent
conv once for each of its applications, no dx for the first conv, no
recomputation) times the images trained in the traced window, over the
window's seconds, as a share of the peak of the cell's compute type."""

from port_bench import families, yardstick


def read(r):
    fam = families.of_readings(r)
    if fam is None:
        return None
    flops = fam.train_flops(r["config"]["model"], r["height"], r["width"])
    return 100.0 * flops * r["images"] / r["window_s"] / yardstick.PEAK_FLOP_S[r["dtype"]]
