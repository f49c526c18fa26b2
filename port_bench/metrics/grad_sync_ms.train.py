"""``grad_sync_ms.train``: device milliseconds a step between the events of
the program's ``train.grad_sync`` spans (the all-reduce of the gradients'
mean over the data-parallel ranks, ``parallel/mesh.py::pmean``), on the
run's own rank."""

from port_bench import program_spans


def read(r):
    return program_spans.device_ms_per_step(r, {"train.grad_sync"})
