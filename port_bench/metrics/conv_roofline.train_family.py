"""``conv_roofline.train_family``: ``conv_roofline.train`` for a family of
``families/``: the least time the step's convs could take (the family's
``conv_bound_s``, each recurrent application counted) for the images of the
traced window, over the device time of every operation that the
benchmark's glue patterns do not match (``yardstick.is_conv_kernel``)."""

from port_bench import families, yardstick


def read(r):
    fam = families.of_readings(r)
    if fam is None or r["trace"] is None:
        return None
    conv_s, _ = yardstick.split_device_time(r["trace"]["ops"])
    if conv_s <= 0:
        return None
    least = fam.conv_bound_s(r["config"]["model"], r["height"], r["width"], r["dtype"],
                             train=True)
    return 100.0 * least * r["images"] / conv_s
