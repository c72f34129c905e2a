"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, in GB (1e9 bytes): the memory the cell's batch or
cache needs."""


def read(run):
    peak = run.memory.get("window_peak_bytes")
    return None if not peak else peak / 1e9
