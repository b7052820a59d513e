"""Device launches a profiled train step. Layer: training
(make_train_step). Moves train_step_ms."""

LAYER = "training"
MOVES = "train_step_ms"


def read(s):
    return s["device_events"] / s["units"] if "train_ops" in s and s["device_events"] else None
