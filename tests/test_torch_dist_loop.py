"""The port's data-parallel training runtime on the CPU: train_model over
two gloo ranks (tests/torch_dist_ranks.py) against one process, and the
train CLI as two torchrun-style ranks against one process.

- train_model of a tiny UNet (SGD, cross entropy) for 2 epochs on a packed
  set: each rank loads its rows of every global batch, the ranks' rows are
  reduced, so both ranks read the same history, and it equals one
  process's on the whole batches within 1e-4 relative (f32 sums in another
  order over two epochs of SGD); the ranks start from their own seeded
  inits and replicate_state gives them rank 0's. Only rank 0 prints and
  writes the checkpoint, its meta and TensorBoard files. A resume from
  rank 0's checkpoint on both ranks (each after a barrier) restores its
  step and takes the new learning rate.
- cli.train_isprs.main with WORLD_SIZE/RANK/MASTER_* set, --device cpu:
  the group is gloo, -bs stays the global batch, the history equals one
  process's, and rank 0 alone prints.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

from resuneta_torch.cli import train_isprs as tcli
from resuneta_torch.data import write_packed_dataset
from resuneta_torch.parallel import launch
from resuneta_torch.train import checkpoint
from resuneta_torch.train.loop import epoch_batches
from util_synth import synth_patches
import torch_dist_ranks as ranks

RTOL = 1e-4


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """2 patches x 5 variants: 8 train samples (2 global batches of 4) and
    2 validation samples (one short batch, 1 a rank)."""
    images, ids = synth_patches(2, 32, 3, 3, seed=21)
    root = str(tmp_path_factory.mktemp("packed"))
    write_packed_dataset(root, images, ids, 3)
    return root


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for split in ("train", "val"):
            assert list(g[split]) == list(w[split])
            np.testing.assert_allclose(list(g[split].values()),
                                       list(w[split].values()),
                                       rtol=RTOL, atol=0, err_msg=split)


def test_train_model_over_two_ranks_matches_one(tmp_path, packed):
    res = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    got = ranks.run_ranks(ranks.train_loop, tmp_path / "two", packed, res, 2,
                          4, 0.05)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ranks.train_loop(None, packed, [str(tmp_path / "one")], 2, 4,
                               0.05)
    finally:
        torch.set_num_threads(n)
    r0, r1 = got
    for h in ("history", "resume_history"):     # reduced rows: the same
        assert [(e["train"], e["val"]) for e in r0[h]] == \
            [(e["train"], e["val"]) for e in r1[h]]
    _close(r0["history"], one["history"])
    _close(r0["resume_history"], one["resume_history"])
    for k, v in r0["trained"].items():
        assert torch.equal(v, r1["trained"][k]), k
        torch.testing.assert_close(v, one["trained"][k], rtol=RTOL,
                                   atol=1e-6)
    # rank 0 alone prints and writes
    assert "Training on 8 images" in r0["stdout"]
    assert r1["stdout"] == ""
    assert not os.path.exists(res[1]) and not os.path.exists(
        res[1] + "_resume")
    ckpt = os.path.join(res[0], "best_model.ckpt")
    assert os.path.exists(os.path.join(ckpt, checkpoint.CKPT_FILE))
    with open(ckpt + ".meta.json") as f:
        assert json.load(f) == r0["meta"] == r1["meta"]
    for split in ("train", "val"):
        assert os.listdir(os.path.join(res[0], "logs", split))
    # the resume: both ranks restored rank 0's checkpoint, then one epoch
    saved = torch.load(os.path.join(ckpt, checkpoint.CKPT_FILE),
                       weights_only=True)
    for r in got:
        assert r["resume_step"] == saved["step"] + 2
        assert r["resume_lr"] == 0.025


@pytest.mark.parametrize("n,bs,ranks_,want", [
    (8, 4, 2, (2, 4)), (3, 4, 2, (1, 2)), (2, 4, 2, (1, 2)),
    (3, 4, 1, (1, 3)), (9, 4, 2, (2, 4))])
def test_epoch_batches_keep_the_batch_divisible(n, bs, ranks_, want):
    """The short-batch rule: a set under one batch runs one short batch,
    cut to a multiple of the ranks."""
    assert epoch_batches(n, bs, ranks_) == want


def test_epoch_batches_refuse_fewer_samples_than_ranks():
    with pytest.raises(ValueError, match="cannot make a batch"):
        epoch_batches(1, 4, 2)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


CLI_ARGS = ["--resunet_a", "False", "--multitasking", "False", "--loss",
            "cross_entropy", "-ps", "32", "-bs", "4", "--device", "cpu",
            "--num_classes", "3", "--epochs", "2", "-optm", "sgd"]


def test_train_cli_as_two_torchrun_ranks_matches_one(tmp_path, packed):
    argv = CLI_ARGS + ["-dp", packed, "-rp", str(tmp_path / "run")]
    env = {"WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    out = tmp_path / "ranks"
    out.mkdir()
    launch.spawn(ranks.torchrun_rank, 2,
                 ("resuneta_torch.cli.train_isprs", argv, env, str(out)),
                 timeout_s=ranks.TIMEOUT_S)
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, one = tcli.main(CLI_ARGS + ["-dp", packed, "-rp",
                                       str(tmp_path / "one")])
    finally:
        torch.set_num_threads(n)
    _close(got[0]["history"], one)
    assert "Number of devices: 2 (data-parallel, gloo" in got[0]["stdout"]
    assert "Training on 8 images" in got[0]["stdout"]
    assert got[1]["stdout"] == ""
    assert (tmp_path / "run" / "best_model.ckpt" /
            checkpoint.CKPT_FILE).exists()
