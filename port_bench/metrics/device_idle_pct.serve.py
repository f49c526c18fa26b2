"""``device_idle_pct.serve``: share of the traced window of a serve cell in
which no operation ran on the device."""

from port_bench import yardstick


def read(r):
    if r["kind"] != "serve" or r["trace"] is None:
        return None
    return yardstick.idle_pct(r["trace"]["busy_s"], r["trace"]["window_s"])
