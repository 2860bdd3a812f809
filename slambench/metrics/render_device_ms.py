"""Device milliseconds a traced frame spends in the kernels, copies
and fills launched inside the program's `step.render` range (credited
through the profiler's launch-to-kernel correlation)."""


def read(t):
    s = t.range_device_s.get("step.render")
    return None if s is None else t.per_frame_ms(s)
