"""Tests of the PyTorch port that need a CUDA card: the K1 kernel against its
plain version, and the 64 px model on the card against the CPU plain path.
They skip without a card. This file imports no JAX, so it runs where only
PyTorch is installed, without the JAX-importing tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from resuneta_torch.models import ResUnetA
from resuneta_torch.ops import convseg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _inputs(N, H, W, C, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) / (3 * C ** 0.5)).astype(
        np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (x, a, b, w, bias)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H,W,C,d", [(2, 32, 32, 32, 31),
                                       (2, 16, 16, 128, 15),
                                       (3, 24, 40, 64, 3),
                                       (1, 8, 8, 256, 1)])
def test_kernel_matches_plain(cuda, N, H, W, C, d, dtype):
    """The plain version repeats the kernel's roundings; only the order of
    the f32 sums differs. f32 out: 1e-4 abs on values of magnitude ~1-4.
    bf16 out: a one-ulp flip of the final rounding, at most 2^-7 relative."""
    x, a, b, w, bias = _inputs(N, H, W, C, C + d, cuda)
    x = x.to(dtype)
    launches = convseg.LAUNCHES
    got = convseg.bn_act_conv(x, a, b, w, bias, dilation=d)
    torch.cuda.synchronize()
    assert convseg.LAUNCHES == launches + 1
    assert got.dtype == dtype and got.shape == (N, H, W, C)
    want = convseg.bn_act_conv_reference(x, a, b, w, bias, dilation=d)
    tol = (2 ** -7, 2 ** -7) if dtype == torch.bfloat16 else (0, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.gpu
def test_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    x, a, b, w, bias = _inputs(1, 8, 8, 32, 0, cuda)
    with pytest.raises(ValueError):
        convseg.bn_act_conv(x, a.cpu(), b, w, bias, dilation=1)
    with pytest.raises(ValueError):
        convseg.bn_act_conv(x[..., :16].contiguous(), a[:16], b[:16],
                            w[:, :, :16, :16].contiguous(), bias[:16],
                            dilation=1)


@pytest.mark.gpu
def test_model_on_card_matches_cpu_plain_path(cuda):
    """64 px, f32, TF32 off: 44 launches per forward; the card's seg
    probabilities within 5e-3 of the CPU plain path's (K1 rounds z to bf16
    on both; the f32 activations feeding it differ in their last bits)."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    model = ResUnetA(5, img_size=64, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    with torch.inference_mode():
        want = model(x)
        with convseg.no_tf32():
            model.to(cuda)
            launches = convseg.LAUNCHES
            got = model(x.to(cuda))
            torch.cuda.synchronize()
    assert convseg.LAUNCHES - launches == 44
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=5e-3)
