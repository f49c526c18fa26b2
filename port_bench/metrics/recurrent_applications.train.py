"""``recurrent_applications.train``: the program's
``model.recurrent_applications`` counter a step, the weight-shared
conv -> BN -> ReLU applications of the recurrent units in the forward pass
(t + 1 a unit, two units an RRCNN block). None for a program without the
counter."""

from port_bench import program_spans


def read(r):
    return program_spans.counter_per_step(r, "model.recurrent_applications")
