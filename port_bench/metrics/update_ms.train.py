"""``update_ms.train``: device milliseconds a step between the events of
the program's ``train.clip`` and ``train.optimizer`` spans (the global-norm
clip and the optimizer's update)."""

from port_bench import program_spans


def read(r):
    return program_spans.device_ms_per_step(r, {"train.clip", "train.optimizer"})
