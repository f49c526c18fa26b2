"""``rrcnn_fwd_ms.train``: device milliseconds a step between the events of
the program's ``model.rrcnn`` spans (``models/r2u_unet.py::_rrcnn_apply``:
the projection, both recurrent units and the residual add of each RRCNN
block in the forward pass; their backward runs under autograd, outside
every span). None for a program without the span."""

from port_bench import program_spans


def read(r):
    return program_spans.device_ms_per_step(r, {"model.rrcnn"})
