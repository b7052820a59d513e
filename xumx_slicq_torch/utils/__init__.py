"""Runtime utilities: host allocator reuse, profiling helpers, device info,
and the profile aggregator (`profile_stats`)."""

from .runtime import device_platform, enable_host_malloc_reuse, profile_trace

__all__ = [
    "enable_host_malloc_reuse",
    "profile_trace",
    "device_platform",
]
