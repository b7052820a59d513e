"""Device time of the host-device copies a profiled track (the audio
staged in, the stems back), in ms. Layer: the Separator. Moves
track_latency_p95_ms."""

LAYER = "separator"
MOVES = "track_latency_p95_ms"


def read(s):
    return 1e3 * s["memcpy_s"] / s["units"] if "demix_ops" in s and s["memcpy_s"] > 0 else None
