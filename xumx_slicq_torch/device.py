"""Device choice shared by the port's entry points."""

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


def use_device(dev: torch.device):
    """Make `dev` the calling thread's current card (each thread has its
    own); a no-op on the host and for "cuda" without an index, which means
    the current card."""
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
