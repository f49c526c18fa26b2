"""``dispatch_idle_ms.train``: idle device milliseconds a step whose gap
(the device trace's, on the host clock) started while the host was inside
one of the program's ``train.*`` spans, each gap given to the innermost."""

from port_bench import program_spans


def read(r):
    return program_spans.idle_ms_per_step(r, "train.")
