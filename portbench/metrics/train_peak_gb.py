"""The most device memory the program held over the window's training
steps (``torch.cuda.max_memory_allocated``, reset as the window opens),
in GB of 1e9 bytes."""


def read(run):
    return run.window_peak / 1e9 if run.window_peak else None
