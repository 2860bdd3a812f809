"""Device milliseconds a traced frame spends in the kernels, copies
and fills launched inside the program's `step.band` range (the hybrid's
band march and merge; credited through the profiler's launch-to-kernel
correlation); None where the trace has no such range."""


def read(t):
    s = t.range_device_s.get("step.band")
    return None if s is None else t.per_frame_ms(s)
