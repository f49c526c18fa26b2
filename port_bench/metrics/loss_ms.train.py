"""``loss_ms.train``: device milliseconds a step between the events of the
program's ``train.loss`` spans (``compute_loss``: BCE and Dice)."""

from port_bench import program_spans


def read(r):
    return program_spans.device_ms_per_step(r, {"train.loss"})
