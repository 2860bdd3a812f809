"""Host milliseconds a traced frame spends inside the program's
`step.render` range (its record_function span, under the profiler)."""


def read(t):
    s = t.range_host_s.get("step.render")
    return None if s is None else t.per_frame_ms(s)
