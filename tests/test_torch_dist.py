"""The port's data-parallel pieces on the CPU (resuneta_torch/parallel):
two gloo ranks (tests/torch_dist_ranks.py) against one process on the
whole batch, and the multihost helpers against the JAX package's.

- pmean/psum, bn_stats and tanimoto_dual_loss over 2 ranks, values and
  gradients, against the same functions of the whole batch in one process:
  f32 sums of 4 rows and 4 rows against sums of 8, within 1e-6;
- predict_patches and predict_scene_overlap sharded over 2 ranks against
  one process running the same forward batches: the ids, the overlap map
  and its mean probabilities bit for bit, with a padded tail batch, and
  every rank returning the whole result;
- the 64 px d6 step over the ranks with remat=True equal to the step
  without it, bit for bit (one spawn with the inference cases);
- the multihost helpers bit for bit against resuneta_tpu.parallel.multihost;
- the group's set-up refusing what it must (a backend not named, NCCL on
  the CPU, gloo on a card unasked), a barrier's timeout, a rank's failure
  making the launch raise.
"""

import numpy as np
import pytest
import torch

from resuneta_torch import losses
from resuneta_torch.models import ResUnetA
from resuneta_torch.ops.fused_bn import bn_stats
from resuneta_torch.parallel import init_group, launch, multihost, \
    shard_batch
from resuneta_tpu.parallel import multihost as jmultihost
import torch_dist_ranks as ranks

TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((8, 5)).astype(np.float32),
            "h": (rng.standard_normal((8, 4, 4, 6)) * 2 + 1).astype(
                np.float32),
            # class 2 absent from rows 0-3 only: rank 0's local volume is
            # 0 there, the global one is not
            "label": np.eye(3, dtype=np.float32)[np.concatenate([
                rng.integers(0, 2, (4, 6, 6)),
                rng.integers(0, 3, (4, 6, 6))])],
            "pred": rng.random((8, 6, 6, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    xs = _data()
    rng = np.random.default_rng(1)
    wg = {"mean": rng.standard_normal(6).astype(np.float32),
          "var": rng.standard_normal(6).astype(np.float32)}
    got = ranks.run_ranks(ranks.collectives, tmp_path_factory.mktemp("c"),
                          xs, wg)
    return xs, wg, got


def _cat(parts):
    return torch.cat(list(parts))


def test_pmean_psum_values_and_gradients(collectives):
    """pmean of the ranks' row sums is the whole batch's sum over 2, psum
    the whole sum; the backward all-reduces the cotangent, so each rank's
    rows get the gradient one process gives them."""
    xs, _, got = collectives
    x = torch.tensor(xs["x"], requires_grad=True)
    m, s, t = x.sum(0) / 2, (x * x).sum(0) / 2, x.sum()
    ((m * torch.arange(m.numel())).sum() + s.sum() + 3 * t).backward()
    for r in got:
        torch.testing.assert_close(r["pmean"], m.detach(), **TOL)
        torch.testing.assert_close(r["psum"], t.detach(), **TOL)
    torch.testing.assert_close(_cat(r["pmean_grad"] for r in got), x.grad,
                               **TOL)


def test_bn_stats_are_the_global_batch(collectives):
    """Sync-BN: the mean and variance of all 8 rows on both ranks, and
    the gradient through the pmean'd moments."""
    xs, wg, got = collectives
    h = torch.tensor(xs["h"], requires_grad=True)
    mean, var = bn_stats(h)
    (mean * torch.from_numpy(wg["mean"]) +
     var * torch.from_numpy(wg["var"])).sum().backward()
    for r in got:
        torch.testing.assert_close(r["bn"][0], mean.detach(), **TOL)
        torch.testing.assert_close(r["bn"][1], var.detach(), **TOL)
    torch.testing.assert_close(_cat(r["bn"][2] for r in got), h.grad, **TOL)


def test_tanimoto_dual_loss_takes_the_global_volumes(collectives):
    """The class volumes are the global batch's: the ranks' losses average
    to the whole batch's, and the gradient through the volumes (the dual
    passes the predictions as the label) matches one process's. Rank 0
    alone would see class 2 at volume 0 in one of the two terms."""
    xs, _, got = collectives
    label = torch.tensor(xs["label"])
    pred = torch.tensor(xs["pred"], requires_grad=True)
    loss = losses.tanimoto_dual_loss(label, pred)
    loss.backward()
    torch.testing.assert_close(sum(r["tanimoto"][0] for r in got) / 2,
                               loss.detach(), **TOL)
    torch.testing.assert_close(_cat(r["tanimoto"][1] for r in got),
                               pred.grad, **TOL)
    alone = losses.tanimoto_dual_loss(label[:4], pred[:4].detach())
    assert abs(alone.item() - got[0]["tanimoto"][0].item()) > 1e-3


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """One spawn of two ranks for the sharded inference and the
    rematerialised step over the group: 7 patches of 32 px at batch 4; an
    80 x 96 scene in windows of 32 px every 16 px (3 x 5 = 15 windows, the
    tail batch of 3 padded to 4); the 64 px d6 SGD step on one row a
    rank."""
    rng = np.random.default_rng(3)
    patches = rng.standard_normal((7, 32, 32, 4)).astype(np.float32)
    scene = rng.standard_normal((80, 96, 4)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("sharded")
    weights = tmp / "weights.pt"
    model = ResUnetA(5, img_size=64, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    torch.save(model.state_dict(), weights)
    raw = {"image_u8": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
           "label_ids": rng.integers(0, 5, (2, 64, 64), dtype=np.uint8),
           "aug": np.array([0, 3])}
    return patches, ranks.run_ranks(ranks.sharded_patches, tmp, patches, 4,
                                    scene, 16, (str(weights), raw, 1e-3))


def test_predict_patches_sharded_matches_one_process(sharded):
    """7 patches at batch 4 over 2 ranks: two rows a rank a batch, the
    tail batch of 3 padded to 4. Each rank's forward batches are the ones
    one process runs at batch 2, so the ids agree bit for bit; every rank
    returns all 7, and the probabilities gathered agree likewise."""
    _, got = sharded
    for r in got:
        assert r["sharded"].shape == (7, 32, 32)
        assert r["sharded"].dtype == np.uint8
        np.testing.assert_array_equal(r["sharded"], r["alone"])
        assert r["probs"].shape == (7, 32, 32, 3)
    np.testing.assert_array_equal(got[0]["sharded"], got[1]["sharded"])
    np.testing.assert_array_equal(got[0]["probs"], got[1]["probs"])


def test_predict_scene_overlap_sharded_matches_one_process(sharded):
    """predict_scene_overlap(group=): the windows through
    predict_patches(group=), the canvas folded in window order on every
    rank. Each rank returns the map and mean probabilities one process
    returns from the same forward batches (batch 2), bit for bit."""
    _, got = sharded
    for r in got:
        cmap, mean = r["overlap"]
        assert cmap.shape == (64, 96) and cmap.dtype == np.uint8
        assert mean.shape == (64, 96, 3)
        np.testing.assert_array_equal(cmap, r["overlap_alone"][0])
        np.testing.assert_array_equal(mean, r["overlap_alone"][1])
    np.testing.assert_array_equal(got[0]["overlap"][1], got[1]["overlap"][1])


def test_remat_step_over_the_group_equals_the_plain_step(sharded):
    """make_train_step(remat=True, group=): each block's rerun in the
    backward runs sync-BN's pmean again over the same ranks (the group
    the forward saw, though the backward's thread has no step context)
    and leaves the running buffers alone, so the step equals the step
    without remat on every rank, bit for bit."""
    _, got = sharded
    for r in got:
        plain, remat = r["steps"][False], r["steps"][True]
        np.testing.assert_array_equal(remat["row"], plain["row"])
        np.testing.assert_array_equal(remat["eval_row"], plain["eval_row"])
        for k, v in plain["state_dict"].items():
            assert torch.equal(remat["state_dict"][k], v), k
        assert remat["counts"][0] == 2 * plain["counts"][0] == 88
    for k, v in got[0]["steps"][True]["state_dict"].items():
        assert torch.equal(got[1]["steps"][True]["state_dict"][k], v), k


@pytest.mark.parametrize("n,hosts", [(8, 2), (12, 4), (10, 1), (9, 3)])
def test_multihost_helpers_match_jax(n, hosts):
    for h in range(hosts):
        assert multihost.host_batch_slice(n, hosts, h) == \
            jmultihost.host_batch_slice(n, hosts, h)
        for seed, epoch in ((0, 0), (3, 5)):
            np.testing.assert_array_equal(
                multihost.shard_host_indices(n + 3, hosts, h, seed, epoch),
                jmultihost.shard_host_indices(n + 3, hosts, h, seed, epoch))
    with pytest.raises(ValueError, match="not divisible"):
        multihost.host_batch_slice(n + 1, hosts * 2)


def test_one_process_is_rank_0_of_1():
    """Without a process group: one process, the coordinator; the batch
    assembly is the identity, and shard_batch keeps the whole batch."""
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.is_coordinator()
    batch = {"a": np.arange(6), "b": np.ones((6, 2))}
    assert multihost.assemble_global_batch(batch) is batch
    assert shard_batch(batch, None) is batch
    multihost.barrier(None, "alone")


def test_group_setup_refuses_what_it_must():
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("mpi", "file:///nonexistent", 1, 0)
    with pytest.raises(ValueError, match="nccl takes ranks on cards"):
        init_group("nccl", "cpu", rank=0, world_size=1,
                   init_method="file:///nonexistent")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_group("gloo", None, rank=0, world_size=1,
                       init_method="file:///nonexistent")


def test_shard_batch_takes_contiguous_rows_and_refuses_uneven():
    group = type("G", (), {"rank": 1, "size": 2})()
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    got = shard_batch(batch, group)
    np.testing.assert_array_equal(got["a"], [4, 5, 6, 7])
    np.testing.assert_array_equal(got["b"], batch["b"][4:])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.arange(7), group)


def test_barrier_times_out_naming_itself(tmp_path):
    """Rank 1 arrives 4 s late at a barrier with a 1 s timeout: rank 0
    raises, naming the barrier."""
    got = ranks.run_ranks(ranks.barrier_then_wait, tmp_path, 1, 4.0, 1.0)
    assert got[0] is not None and "test barrier" in got[0]


def test_a_failing_rank_makes_the_launch_raise(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        ranks.run_ranks(ranks.fails_on_rank_1, tmp_path)


def test_rendezvous_refuses_a_leftover_file(tmp_path):
    (tmp_path / "rendezvous").write_text("")
    with pytest.raises(FileExistsError):
        launch.rendezvous(str(tmp_path))
