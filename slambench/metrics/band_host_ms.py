"""Host milliseconds a traced frame spends inside the program's
`step.band` range (the hybrid's band march and merge, its
record_function span, under the profiler); None where the trace has no
such range (a program without the stage, or traced frames that render no
hybrid view)."""


def read(t):
    s = t.range_host_s.get("step.band")
    return None if s is None else t.per_frame_ms(s)
