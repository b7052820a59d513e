"""Device launches (kernels, copies, fills) in the profiled tracks, over
their number. Layer: the Separator (`Separator.forward`). Moves demix_rate."""

LAYER = "separator"
MOVES = "demix_rate"


def read(s):
    return s["device_events"] / s["units"] if "demix_ops" in s and s["device_events"] else None
