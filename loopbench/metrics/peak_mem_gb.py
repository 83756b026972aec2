"""peak_mem_gb: ``torch.cuda.max_memory_allocated`` over the window, in
1e9 bytes: the device memory that bounds the front-end's batch."""


def read(run):
    if not run.cuda:
        return None
    return run.counters["window_peak_bytes"] / 1e9
