"""Device resolution shared by every entry point.

`device=None` means the card. There is no silent CPU fallback: asking for
CUDA where there is none raises, and the plain PyTorch path runs only when
the caller passes `device="cpu"`.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise if a CUDA device is requested and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
