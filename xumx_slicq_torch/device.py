"""Device choice shared by the port's entry points, and the tables cached
per device."""

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """Turn a device name into a torch.device, refusing to run on the CPU
    by accident: "cuda" with no card raises instead of carrying on slowly
    on the host. Pass "cpu" to ask for the host explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the host"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: "cuda" without an index is the current
    card, so it equals "cuda:<current index>"."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def use_device(dev: torch.device):
    """Make `dev` the calling thread's current card (each thread has its
    own); a no-op on the host and for "cuda" without an index, which means
    the current card."""
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def tracing() -> bool:
    """True while a fake-tensor trace runs (torch.export): tensors made then
    are placeholders of the trace, not data."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


_CACHE_SIZE = 64                # layouts a table cache keeps per function


def device_cache(fn):
    """Memoise fn(*args, **kwargs), which builds read-only tables on a
    device from NumPy, filling the cache only outside a trace. Built while
    torch.export traces, the tables are fake tensors that become the
    artifact's constants; cached, they would break every later real call."""
    cache = {}

    @functools.wraps(fn)
    def get(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        hit = cache.get(key)
        if hit is not None:
            return hit
        value = fn(*args, **kwargs)
        if not tracing():
            if len(cache) >= _CACHE_SIZE:
                cache.pop(next(iter(cache)))
            cache[key] = value
        return value

    get.cache_clear = cache.clear
    return get
