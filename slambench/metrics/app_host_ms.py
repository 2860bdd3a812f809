"""Host milliseconds a traced frame spends in the app loop outside the
step's stages and the relocalization: the loop's period minus the
program's step.* and app.reloc ranges (run_slam's signal-slot read and
`consume`: growth, the trajectory bookkeeping; and the frame handed in by
frame_fn)."""


def read(t):
    if not t.frames or not t.range_host_s:
        return None
    return t.per_frame_ms(t.window_s - sum(t.range_host_s.values()))
