"""``mfu.train``: the train step's model FLOPs (every conv, ConvTranspose
and 1x1 of forward, dw and dx, no dx for the first conv, no recomputation;
``yardstick.train_flops``) times the images trained in the traced window,
over the window's seconds, as a share of the peak of the cell's compute
type (bf16 989 TFLOP/s; fp32 494.7, TF32 dense)."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "train":
        return None
    flops = yardstick.train_flops(r["config"]["model"], r["height"], r["width"])
    return 100.0 * flops * r["images"] / r["window_s"] / yardstick.PEAK_FLOP_S[r["dtype"]]
