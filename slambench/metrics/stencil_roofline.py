"""The sensor stencils' share of their roofline, in percent: the summed
least times of the bilateral (csrc bilateral_kernel, the radius-3
instance at the configurations' 7x7) and gated_pyramid5x5 launches at the
frame's shapes (slambench/roofline.py) over their summed device time."""

from slambench import roofline


def read(t):
    s = t.slam
    shape = (s["height"], s["width"])
    levels = s["pyramid_depth"] - 1
    bound = spent = 0.0
    for name, dur, batch in t.kernels:
        if "gated_pyramid5x5" in name:
            work = roofline.gated_pyramid_work((batch,) + shape, levels)
        elif "bilateral_kernel" in name or "bilateral_window" in name:
            work = roofline.bilateral_work((batch,) + shape,
                                           s["bilateral_kernel_size"])
        else:
            continue
        bound += roofline.bound_s(*work)
        spent += dur
    if spent <= 0.0:
        return None
    return 100.0 * bound / spent
