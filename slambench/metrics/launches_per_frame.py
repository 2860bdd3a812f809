"""Kernels the profiler records per traced frame (launched inside the
traced window; copies and fills are not kernels)."""


def read(t):
    if not t.frames or not t.kernels:
        return None
    return len(t.kernels) / t.frames
