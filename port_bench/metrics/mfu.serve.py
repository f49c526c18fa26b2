"""``mfu.serve``: the forward's model FLOPs an image at the served size
(``yardstick.forward_flops``) times the masks returned in the window, over
the window's seconds, as a share of the peak of the served compute type."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "serve":
        return None
    flops = yardstick.forward_flops(r["config"]["model"], r["height"], r["width"])
    return 100.0 * flops * r["images"] / r["window_s"] / yardstick.PEAK_FLOP_S[r["dtype"]]
