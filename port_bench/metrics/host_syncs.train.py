"""``host_syncs.train``: the program's ``train.host_syncs`` counter a step,
the synchronising CUDA calls made inside the step (sync-debug detections,
the caching allocator's cudaMalloc and cudaFree calls)."""

from port_bench import program_spans


def read(r):
    return program_spans.counter_per_step(r, "train.host_syncs")
