"""Share of the traced frames' wall time with no kernel, copy or fill on
the card, in percent."""


def read(t):
    if t.window_s <= 0.0 or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
