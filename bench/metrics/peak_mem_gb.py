"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window (reset
at its start), in GB (1e9 bytes): what training holds on the card."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_window_bytes / 1e9
