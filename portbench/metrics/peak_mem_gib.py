"""The device memory the window's epochs hold at their peak, in GiB
(``torch.cuda.max_memory_allocated`` since the window opened, the staged
set included): it decides whether a user's set trains on the device or
streams from the host."""

MOVES = "peak_mem_gib"


def read(run):
    return run.window_peak_bytes / 2**30
