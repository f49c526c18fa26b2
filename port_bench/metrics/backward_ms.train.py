"""``backward_ms.train``: device milliseconds a step between the events of
the program's ``train.backward`` spans (``torch.autograd.grad``)."""

from port_bench import program_spans


def read(r):
    return program_spans.device_ms_per_step(r, {"train.backward"})
