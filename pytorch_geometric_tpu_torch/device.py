"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for CUDA
where there is none raises: nothing falls back to the CPU on its own, so
a run that was meant for the card can never quietly measure the host.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch paths")
    return dev
