"""``glue_ms.train``: device milliseconds a step of the operations that the
benchmark's glue patterns match (elementwise, reductions, copies, fills,
pools: BN, the loss, the optimizer, the clip, the casts)."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "train" or r["trace"] is None or not r["steps"]:
        return None
    _, glue_s = yardstick.split_device_time(r["trace"]["ops"])
    return 1e3 * glue_s / r["steps"]
