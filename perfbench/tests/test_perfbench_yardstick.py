"""The yardstick's counts against the port's model, and the reference's
parameter layout against the port's, at small sizes on the CPU."""

import pytest
import torch

from harness import weights, yardstick
from harness.main import HERE, load_json
from reference.model import layout

CONFIGS = ("resuneta-d6-isprs-bf16", "resuneta-d6-amazon-f32")


def _model(cfg, P):
    from resuneta_torch.models import ResUnetA

    return ResUnetA(cfg["num_classes"], img_size=P, multitasking=True,
                    color_head=cfg["color_head"],
                    in_channels=cfg["in_channels"], device="cpu")


def _cfg(name):
    return load_json(HERE, "configs", f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_equal_a_count_by_hooks(name, P=64):
    from resuneta_torch.models.resuneta import Conv

    cfg = dict(_cfg(name), img_size=P)
    model = _model(cfg, P)
    macs = []

    def hook(mod, inp, out):
        macs.append(out.numel() * mod.weight.shape[1] * mod.kernel_size ** 2)

    for mod in model.modules():
        if isinstance(mod, Conv):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.rand(2, P, P, cfg["in_channels"]))
    assert 2 * sum(macs) == 2 * yardstick.forward_flops(cfg, P)
    assert yardstick.train_flops(cfg, P) == \
        3 * yardstick.forward_flops(cfg, P) - \
        2 * P * P * 32 * cfg["in_channels"]


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_ports_state_dict(name):
    cfg = _cfg(name)
    with torch.device("meta"):
        from resuneta_torch.models import ResUnetA
        model = ResUnetA(cfg["num_classes"], img_size=cfg["img_size"],
                         color_head=cfg["color_head"],
                         in_channels=cfg["in_channels"], device="meta")
    sd = model.state_dict()
    lay = {n: s for n, s, _ in layout(cfg)}
    assert set(lay) == set(sd)
    assert all(tuple(sd[n].shape) == s for n, s in lay.items())
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]


def test_weights_repeat_from_the_seed_and_load_into_the_port():
    cfg = dict(_cfg("resuneta-d6-isprs-bf16"), img_size=64)
    a = weights.make(cfg, 2 ** 31 + 77, "cpu")
    b = weights.make(cfg, 2 ** 31 + 77, "cpu")
    c = weights.make(cfg, 2 ** 31 + 78, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv_0.weight"], c["Conv_0.weight"])
    model = _model(cfg, 64)
    model.load_state_dict(a)


def test_segments_are_the_44_fused_segments_of_a_256_px_forward():
    cfg = _cfg("resuneta-d6-isprs-bf16")
    segs = yardstick.segments(cfg, 256)
    assert len(segs) == 44
    assert {(c, h) for c, h, _, _ in segs} == {(32, 256), (64, 128),
                                               (128, 64)}
    # the least time of a call is bound by bytes at these widths
    t = yardstick.k1_seconds(128, 256, 256, 32, 2)
    assert t == pytest.approx(2 * 128 * 256 * 256 * 32 * 2 /
                              yardstick.PEAK_BYTES, rel=1e-3)
