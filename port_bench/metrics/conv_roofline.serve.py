"""``conv_roofline.serve``: the least time the forward's convs could take
for the masks returned in the window (``yardstick.conv_bound_s``), over the
device time of every operation that the glue patterns do not match. The
canvas's padding rows and the resize, upscale, threshold and pool kernels
are not counted as conv work."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "serve" or r["trace"] is None:
        return None
    conv_s, _ = yardstick.split_device_time(r["trace"]["ops"])
    if conv_s <= 0:
        return None
    least = yardstick.conv_bound_s(r["config"]["model"], r["height"], r["width"], r["dtype"],
                                   train=False)
    return 100.0 * least * r["images"] / conv_s
