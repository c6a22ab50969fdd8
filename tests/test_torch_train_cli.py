"""The port's epoch loop (resuneta_torch/train/loop.py) and train CLI
(resuneta_torch/cli/train_isprs.py) against the JAX package's on the CPU.

The loop, scripted: both train_models are driven by the same step
functions, whose metric rows are a fixed function of the batch's sample
ids and the epoch (no model runs), over each package's ArrayDataset of
sample ids; the JAX side carries a small pytree state through orbax. Held
exactly: stdout character for character, the history's train/val dicts,
the epochs that saved a best checkpoint, the meta JSON, and the
TensorBoard scalars read back from both event directories (the
Perf/patches_per_sec values are wall-clock times, so only their steps;
where the dataset is shorter than a batch the port counts that batch's
samples and the reference counts none, so there the port runs on a
scripted clock and its values are held to n_train / 1 s).

The loop, for real: both packages train a tiny UNet (base_filters 4,
32 px, batch 4, 4 packed patches with the 5 augmentation variants) for 2
epochs on the CPU from the same weights (convert.from_flax): the shuffle
order exactly, every history value within 1e-3 relative (f32 convolutions
summed in another order, compounded over 8 Adam steps), the same best
epochs.

The CLI on the CPU: UNet at 64 px trains, writes its checkpoint, meta and
TensorBoard logs, and resumes with a new learning rate; its arguments are
the JAX CLI's plus --device; --gpu_parallel with several cards spawns one
rank a card (both train CLIs), and runs in process otherwise."""

import itertools
import json
import os
import struct
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert
from resuneta_torch import losses as tlosses
from resuneta_torch.cli import train_amazon as acli
from resuneta_torch.cli import train_isprs as tcli
from resuneta_torch.data import ArrayDataset, PackedDataset, \
    make_device_pipeline, write_packed_dataset
from resuneta_torch.data.split import train_test_split
from resuneta_torch.kernels import build
from resuneta_torch.models import UNet
from resuneta_torch.parallel import launch
from resuneta_torch.train import (METRICS_MULTITASK, METRICS_SINGLE,
                                  TrainConfig, TrainState, checkpoint,
                                  create_train_state, make_eval_step,
                                  make_train_step, train_model)
from resuneta_torch.train import loop as tloop
from resuneta_tpu import losses as jlosses
from resuneta_tpu.cli import train_isprs as jcli
from resuneta_tpu.data import ArrayDataset as JArrayDataset
from resuneta_tpu.data import PackedDataset as JPackedDataset
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.models import UNet as JUNet
from resuneta_tpu.train import TrainConfig as JTrainConfig
from resuneta_tpu.train import checkpoint as jcheckpoint
from resuneta_tpu.train import loop as jloop
from resuneta_tpu.train import make_eval_step as jmake_eval_step
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train import train_model as jtrain_model
from resuneta_tpu.train.state import TrainState as JTrainState
from resuneta_tpu.train.state import make_optimizer as jmake_optimizer
from test_torch_model import flax_variables
from util_synth import synth_patches
from util_torch import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


# ---------------------------------------------------------- scripted loop

class Script:
    """Train and eval steps whose rows are a fixed function of the batch's
    sample ids and the epoch; the validation loss of epoch e is
    val_losses[e] (exact in f32). `to` makes a row the package's own
    kind: a numpy array for JAX, a tensor for the port."""

    def __init__(self, n_metrics, n_train, n_val, batch, val_losses, to):
        self.n = n_metrics
        self.per_epoch = {"train": n_train // batch or 1,
                          "eval": n_val // batch or 1}
        self.calls = {"train": 0, "eval": 0}
        self.val_losses = val_losses
        self.to = to

    def _epoch(self, kind):
        epoch = self.calls[kind] // self.per_epoch[kind]
        self.calls[kind] += 1
        return epoch

    def _row(self, ids, epoch):
        j = np.arange(self.n)
        s = float(np.asarray(ids, np.float64).sum()) + 1.0
        row = (s * (j + 1) / 97.0 + epoch / 7.0) % 1.0
        row[len(row) - 4:] *= 1000.0           # the four threshold counts
        return row.astype(np.float32)

    def train(self, state, raw):
        return state, self.to(self._row(raw["id"], self._epoch("train")))

    def eval(self, state, raw):
        epoch = self._epoch("eval")
        row = self._row(raw["id"], epoch + 50)
        row[0] = self.val_losses[epoch]
        return self.to(row)


# case: (multitasking, train samples, val samples, batch, epochs,
# patience, delta, validation losses by epoch)
LOOP_CASES = {
    "multitask": (True, 12, 4, 4, 3, 10, 1e-3, [1.0, 0.5, 0.75]),
    "single_task_early_stop": (False, 8, 4, 4, 6, 2, 1e-3,
                               [1.0, 1.25, 1.5, 1.75, 2.0, 2.25]),
    # 0.5 + delta is exactly min + delta: the reference counts it as no
    # improvement (>=); 0.5 + delta / 2 then is one
    "tie_at_min_plus_delta": (False, 8, 4, 4, 4, 10, 2.0 ** -10,
                              [0.5, 0.5 + 2.0 ** -10, 0.5 + 2.0 ** -11,
                               0.25]),
    "shorter_than_a_batch": (True, 3, 2, 4, 2, 10, 1e-3, [0.75, 0.5]),
}


def _record(monkeypatch, module, name, log):
    orig = getattr(module, name)

    def wrapped(self, *args, **kw):
        log.append(args[2] if len(args) > 2 else kw["epoch"])
        return orig(self, *args, **kw)

    monkeypatch.setattr(module, name, wrapped)


def _capture_writers(monkeypatch, module, made):
    orig = module._writers

    def wrapped(config):
        made.extend(orig(config))
        return made[-2], made[-1]

    monkeypatch.setattr(module, "_writers", wrapped)


def _scalars(logdir):
    """{tag: [(step, value)]} of the event files under `logdir`, read with
    tensorboardX's protobufs (records: u64 length, u32 crc, the Event, u32
    crc)."""
    from tensorboardX.proto import event_pb2

    out = {}
    for path in sorted(Path(logdir).glob("events.out.tfevents.*")):
        data, i = path.read_bytes(), 0
        while i < len(data):
            n = struct.unpack("<Q", data[i:i + 8])[0]
            event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_scripted_loop_matches_jax(tmp_path, monkeypatch, capsys, case):
    pytest.importorskip("tensorboardX")
    multitask, n_train, n_val, bs, epochs, patience, delta, val_losses = \
        LOOP_CASES[case]
    names = METRICS_MULTITASK if multitask else METRICS_SINGLE
    saved = {"jax": [], "port": []}
    _record(monkeypatch, jcheckpoint.AsyncSaver, "save_best", saved["jax"])
    _record(monkeypatch, checkpoint.AsyncSaver, "save_best", saved["port"])
    writers = {"jax": [], "port": []}
    _capture_writers(monkeypatch, jloop, writers["jax"])
    _capture_writers(monkeypatch, tloop, writers["port"])
    out, hist = {}, {}
    for side in ("jax", "port"):
        cfg = (JTrainConfig if side == "jax" else TrainConfig)(
            results_path=str(tmp_path / side), batch_size=bs, epochs=epochs,
            multitasking=multitask, patience=patience, delta=delta, seed=7)
        if side == "jax":
            script = Script(len(names), n_train, n_val, bs, val_losses,
                            np.asarray)
            state = types.SimpleNamespace(
                params={"w": np.zeros(3, np.float32)},
                batch_stats={"mean": np.zeros(2, np.float32)},
                opt_state={"mu": np.zeros(3, np.float32)},
                step=np.int32(0))
            _, hist[side] = jtrain_model(
                cfg, state, script.train, script.eval,
                JArrayDataset({"id": np.arange(n_train)}),
                JArrayDataset({"id": np.arange(100, 100 + n_val)}))
        else:
            script = Script(len(names), n_train, n_val, bs, val_losses,
                            torch.as_tensor)
            lin = torch.nn.Linear(2, 2)
            state = TrainState(lin, torch.optim.SGD(lin.parameters(), 0.1))
            if case == "shorter_than_a_batch":
                # a clock that moves 1 s a reading: each epoch's train
                # pass takes 1 s
                monkeypatch.setattr(tloop, "time", types.SimpleNamespace(
                    time=itertools.count(0.0).__next__))
            _, hist[side] = train_model(
                cfg, state, script.train, script.eval,
                ArrayDataset({"id": np.arange(n_train)}),
                ArrayDataset({"id": np.arange(100, 100 + n_val)}))
        for w in writers[side]:
            if w is not None:
                w.close()
        out[side] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "Saving best model..." in out["port"]
    assert [(h["train"], h["val"]) for h in hist["port"]] == \
        [(h["train"], h["val"]) for h in hist["jax"]]
    assert saved["port"] == saved["jax"]
    meta = [json.loads((tmp_path / s / "best_model.ckpt.meta.json")
                       .read_text()) for s in ("port", "jax")]
    assert meta[0] == meta[1]
    for split in ("train", "val"):
        got = _scalars(tmp_path / "port" / "logs" / split)
        want = _scalars(tmp_path / "jax" / "logs" / split)
        assert sorted(got) == sorted(want) and got
        for tag in want:
            if tag == "Perf/patches_per_sec":
                assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
            else:
                assert got[tag] == want[tag], tag
    if case == "single_task_early_stop":
        assert len(hist["port"]) == 3 and "Early Stopping!" in out["port"]
    if case == "tie_at_min_plus_delta":
        assert saved["port"] == [0, 2, 3]
    if case == "shorter_than_a_batch":
        # the port counts the short batch's samples, where the reference
        # counts none (n_seen 0): n_train patches in the 1 s pass
        want = [float(n_train)] * epochs
        assert [h["patches_per_sec"] for h in hist["port"]] == want
        assert [v for _, v in _scalars(tmp_path / "port" / "logs" / "train")
                ["Perf/patches_per_sec"]] == want
        assert [h["patches_per_sec"] for h in hist["jax"]] == [0.0] * epochs


def test_an_exception_in_train_model_still_drains_the_saver(tmp_path,
                                                           monkeypatch):
    """A step that raises in epoch 1, after epoch 0's best save was handed
    to the background writer (held until the step has raised): the
    checkpoint and its meta are on disk when train_model has raised."""
    import threading

    release = threading.Event()
    write = checkpoint._write_ckpt

    def held(*args):
        assert release.wait(10)
        write(*args)

    monkeypatch.setattr(checkpoint, "_write_ckpt", held)
    lin = torch.nn.Linear(2, 2)
    state = TrainState(lin, torch.optim.SGD(lin.parameters(), 0.1))
    script = Script(len(METRICS_SINGLE), 4, 4, 4, [1.0, 0.5],
                    torch.as_tensor)

    def train(state, raw):
        if script.calls["train"] == 1:
            release.set()
            raise KeyboardInterrupt
        return script.train(state, raw)

    cfg = TrainConfig(results_path=str(tmp_path), batch_size=4, epochs=2,
                      multitasking=False, tensorboard=False, verbose=False)
    with pytest.raises(KeyboardInterrupt):
        train_model(cfg, state, train, script.eval,
                    ArrayDataset({"id": np.arange(4)}),
                    ArrayDataset({"id": np.arange(4)}))
    assert (tmp_path / "best_model.ckpt" / checkpoint.CKPT_FILE).exists()
    assert json.loads((tmp_path / "best_model.ckpt.meta.json").read_text()) \
        == {"epoch": 0, "min_val_loss": 1.0}


def test_profile_dir_writes_a_chrome_trace_of_epoch_0(tmp_path):
    lin = torch.nn.Linear(2, 2)
    state = TrainState(lin, torch.optim.SGD(lin.parameters(), 0.1))
    script = Script(len(METRICS_SINGLE), 4, 4, 4, [1.0, 0.5],
                    torch.as_tensor)
    cfg = TrainConfig(results_path=str(tmp_path / "res"), batch_size=4,
                      epochs=2, multitasking=False, tensorboard=False,
                      verbose=False, profile_dir=str(tmp_path / "prof"))
    train_model(cfg, state, script.train, script.eval,
                ArrayDataset({"id": np.arange(4)}),
                ArrayDataset({"id": np.arange(4)}))
    trace = json.loads((tmp_path / "prof" / "epoch_0.trace.json").read_text())
    assert trace["traceEvents"]


# -------------------------------------------------------------- real loop

def test_loop_trains_a_tiny_unet_as_jax_does(tmp_path):
    nc, ps, bs = 3, 32, 4
    images, ids = synth_patches(4, ps, 3, nc, seed=12)
    root = str(tmp_path / "ds")
    write_packed_dataset(root, images, ids, nc)
    tr, va = train_test_split(np.arange(20), test_size=0.2, random_state=42)
    jmodel = JUNet(num_classes=nc, base_filters=4)
    variables = flax_variables(jmodel, [jnp.zeros((1, ps, ps, 3))], seed=4)
    tx = jmake_optimizer("adam", 1e-3)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"], batch_stats={},
                         opt_state=tx.init(variables["params"]), tx=tx,
                         apply_fn=jmodel.apply)
    model = UNet(nc, base_filters=4, device="cpu")
    model.load_state_dict(convert.from_flax(variables, model))
    state = create_train_state(model, "adam", 1e-3)

    positions = {"jax": [], "port": []}

    def recorded(ds, log):
        get = ds.get_batch

        def get_batch(pos):
            log.append(list(map(int, pos)))
            return get(pos)

        ds.get_batch = get_batch
        return ds

    saved = {"jax": [], "port": []}
    hist = {}
    for side in ("jax", "port"):
        full = (JPackedDataset if side == "jax" else PackedDataset)(root)
        train_ds = recorded(full.subset(tr), positions[side])
        val_ds = recorded(full.subset(va), positions[side])
        cfg = (JTrainConfig if side == "jax" else TrainConfig)(
            results_path=str(tmp_path / side), batch_size=bs, epochs=2,
            multitasking=False, seed=5, tensorboard=False, verbose=False,
            async_checkpoint=False, keep_last=0)
        log = saved[side]
        if side == "jax":
            loss = jlosses.make_losses("cross_entropy")
            pipe = jmake_device_pipeline(nc, 1, False)
            tstep = jmake_train_step(loss, {}, False, preprocess=pipe,
                                     donate=False)
            estep = jmake_eval_step(loss, {}, False, preprocess=pipe)
            save = jloop.save_best
            jloop.save_best = lambda p, s, e, m: (log.append(e),
                                                  save(p, s, e, m))
            try:
                _, hist[side] = jtrain_model(cfg, jstate, tstep, estep,
                                             train_ds, val_ds)
            finally:
                jloop.save_best = save
        else:
            loss = tlosses.make_losses("cross_entropy")
            pipe = make_device_pipeline(nc, 1, False, device="cpu")
            tstep = make_train_step(loss, {}, False, preprocess=pipe,
                                    device="cpu")
            estep = make_eval_step(loss, {}, False, preprocess=pipe,
                                   device="cpu")
            save = tloop.save_best
            tloop.save_best = lambda p, s, e, m: (log.append(e),
                                                  save(p, s, e, m))
            try:
                _, hist[side] = train_model(cfg, state, tstep, estep,
                                            train_ds, val_ds)
            finally:
                tloop.save_best = save
    assert positions["port"] == positions["jax"]
    assert len(positions["port"]) == 2 * (16 // bs + 1)
    assert saved["port"] == saved["jax"] and saved["port"]
    for got, want in zip(hist["port"], hist["jax"]):
        for split in ("train", "val"):
            assert list(got[split]) == list(want[split])
            np.testing.assert_allclose(list(got[split].values()),
                                       list(want[split].values()),
                                       rtol=1e-3, atol=0, err_msg=split)
    assert hist["port"][1]["train"]["loss"] < hist["port"][0]["train"]["loss"]


# -------------------------------------------------------------------- CLI

def _option_table(parser):
    return {tuple(a.option_strings): (a.default, a.choices, a.type)
            for a in parser._actions if a.option_strings}


def test_cli_arguments_are_the_jax_clis_plus_device():
    got = _option_table(tcli.build_parser())
    want = _option_table(jcli.build_parser())
    assert got.pop(("--device",))[0] is None
    assert sorted(got) == sorted(want)
    for opt, (default, choices, typ) in want.items():
        assert got[opt][:2] == (default, choices), opt
        assert getattr(got[opt][2], "__name__", None) == \
            getattr(typ, "__name__", None), opt


@pytest.fixture(scope="module")
def packed64(tmp_path_factory):
    """Two 64 px patches with the 5 variants: the CLI's split gives 8
    train samples (2 steps at batch 4) and 2 validation samples (one short
    batch)."""
    images, ids = synth_patches(2, 64, 3, 5, seed=13)
    root = str(tmp_path_factory.mktemp("packed64"))
    write_packed_dataset(root, images, ids, 5)
    return root


def test_cli_trains_unet_on_the_cpu_and_resumes(tmp_path, capsys, packed64):
    args = ["--resunet_a", "False", "--multitasking", "False", "--loss",
            "cross_entropy", "-ps", "64", "-bs", "4", "--device", "cpu",
            "-dp", packed64]
    res = tmp_path / "run"
    state, history = tcli.main(args + ["-rp", str(res), "--epochs", "2"])
    assert isinstance(state.model, UNet) and len(history) == 2
    assert state.step == 4 and state.learning_rate == 1e-3
    ckpt = res / "best_model.ckpt"
    assert (ckpt / checkpoint.CKPT_FILE).exists()
    meta = json.loads(Path(str(ckpt) + ".meta.json").read_text())
    assert meta["epoch"] in (0, 1)
    for split in ("train", "val"):
        assert os.listdir(res / "logs" / split)
    out = capsys.readouterr().out
    assert "Training on 8 images" in out and "Validating on 2 images" in out
    saved = torch.load(ckpt / checkpoint.CKPT_FILE, weights_only=True)

    # --gpu_parallel is a no-op with one card or none
    state2, history2 = tcli.main(args + [
        "-rp", str(tmp_path / "resume"), "--epochs", "1", "-cp", str(ckpt),
        "-lr", "5e-4", "--gpu_parallel", "True"])
    assert state2.learning_rate == 5e-4
    assert all(g["lr"] == 5e-4 for g in state2.optimizer.param_groups)
    assert state2.step == saved["step"] + 2 and len(history2) == 1
    out = capsys.readouterr().out
    assert f"[INFO] loading {ckpt}..." in out
    assert "[INFO] new learning rate: 0.0005" in out


@pytest.mark.parametrize("cli", [tcli, acli], ids=["isprs", "amazon"])
def test_cli_gpu_parallel_spawns_one_rank_a_card(monkeypatch, cli):
    """--gpu_parallel True with 2 visible cards builds the kernels once,
    then spawns 2 ranks of the CLI's run (NCCL, one a card) through a
    file:// rendezvous and returns rank 0's history; with one card, with
    --gpu_parallel False or on the CPU it runs here, without a group."""
    calls = []
    monkeypatch.setattr(cli, "run", lambda args, group=None: (
        calls.append(("run", group)) or ("state", ["history"])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(build, "build_all",
                        lambda: calls.append(("build",)))

    def spawn(fn, nprocs, args, timeout_s):
        calls.append(("spawn", fn, nprocs, args[0], args[2], args[3]))
        with open(args[4], "w") as f:
            json.dump(["rank 0's history"], f)

    monkeypatch.setattr(launch, "spawn", spawn)
    assert cli.main(["--gpu_parallel", "True"]) == \
        (None, ["rank 0's history"])
    assert calls[0] == ("build",)
    _, fn, nprocs, run, world, init = calls[1]
    assert (fn, nprocs, run, world) == (launch._cli_rank, 2, cli.run, 2)
    assert init.startswith("file://") and len(calls) == 2
    for argv in (["--gpu_parallel", "False"],
                 ["--gpu_parallel", "True", "--device", "cpu"]):
        calls.clear()
        assert cli.main(argv) == ("state", ["history"])
        assert calls == [("run", None)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls.clear()
    assert cli.main(["--gpu_parallel", "True"]) == ("state", ["history"])
    assert calls == [("run", None)]


def test_cli_defaults_to_the_card(packed64, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["-dp", packed64, "-rp", str(tmp_path)])
