"""``conv_roofline.train``: the least time the step's convs could take
(Σ over forward, dw and dx of each conv of the larger of its FLOPs over the
peak and its bytes over 3.35 TB/s; ``yardstick.conv_bound_s``) for the images
of the traced window, over the device time of every operation that the
benchmark's glue patterns do not match (``yardstick.is_conv_kernel``)."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "train" or r["trace"] is None:
        return None
    conv_s, _ = yardstick.split_device_time(r["trace"]["ops"])
    if conv_s <= 0:
        return None
    least = yardstick.conv_bound_s(r["config"]["model"], r["height"], r["width"], r["dtype"],
                                   train=True)
    return 100.0 * least * r["images"] / conv_s
