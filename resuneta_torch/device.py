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


def check_current_device(t):
    """Raise unless the CUDA tensor `t` lies on the current device. The
    kernels query and set attributes (SM count, shared memory) of the
    current device, and a data-parallel rank works on its own card, made
    current by parallel.init_group: a tensor on another card is a fault to
    report, not a launch to make."""
    cur = torch.cuda.current_device()
    if t.device.index != cur:
        raise ValueError(
            f"the kernel's tensors are on {t.device} but the current device "
            f"is cuda:{cur}: call torch.cuda.set_device({t.device.index}) "
            "(parallel.init_group does) before launching")
