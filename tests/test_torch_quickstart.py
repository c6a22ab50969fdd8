"""examples/quickstart_torch.py on the CPU: a synthetic scene through the
port's preprocess, train and test CLIs at 1 epoch. The test draws the
example's scene at 128^2 in place of 256^2 (9 patches at the example's
stride 32, 45 with the augmentation variants) to keep within its time.
It writes the packed set, the checkpoint, and the predictions with their
figures, and its history and metrics are finite."""

import functools
import importlib.util
import os
from pathlib import Path

import numpy as np

from util_torch import one_thread  # noqa: F401  (fixture)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


def test_quickstart_writes_its_checkpoint_and_predictions(tmp_path,
                                                          one_thread,
                                                          monkeypatch):
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "synthetic_scene",
                        functools.partial(mod.synthetic_scene, 128))
    out = mod.main(["--device", "cpu", "--epochs", "1",
                    "--workdir", str(tmp_path)])
    assert out["workdir"] == str(tmp_path)
    assert (tmp_path / "patches").is_dir()
    assert os.path.isfile(os.path.join(out["checkpoint"], "checkpoint.pt"))
    preds = Path(out["predictions"])
    assert (preds / "pred_seg_reconstructed.jpeg").is_file()
    assert len(out["history"]) == 1
    vals = [v for sp in ("train", "val")
            for v in out["history"][0][sp].values()]
    assert np.isfinite(vals).all()
    assert 0 <= out["metrics"][0] <= 100
    assert set(out["seconds"]) == {"preprocess", "train", "test"}
