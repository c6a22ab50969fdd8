"""Training traffic, driven as resuneta_torch's epoch loop drives it
(train/loop.py `_epoch_pass`): positions from a shuffled order, then
`ds.get_batch(positions)` of an in-memory `ArrayDataset`, then the step
that `make_train_step` returns, its metric rows kept on the device.

The traffic file gives the pool (`pool` patches of `patch` px made from
the seed in host memory), the batch, the input kind and the steps of
set-up and of the traced slice:
- "rgb_u8": uint8 RGB patches of seeded Voronoi class maps (region sizes
  from `cell_px`, one size a patch in turn, classes drawn with
  `class_share`), their uint8 class ids and a seeded augmentation
  variant a patch, through the program's device pipeline
  (`make_device_pipeline`: augmentation, /255, one-hot, boundary,
  distance, HSV on the card);
- "bands_f32": float32 patches of `bands` bands with one-hot labels of
  seeded blobs (class 1 `share_def`, class 2 `share_past` of the pixels),
  through `make_label_head_pipeline` (boundary and distance on the card).
Every seed gets the same patch sizes, cell sizes and shares; only the
draws differ.

Set-up builds one train state and one step, and drives it through the
window's own call and feed for `first_steps` (3) batches that all differ:
the reference follows those, from the Adam state after the first (the
first gradient is exp_avg / (1 - b1)) and the parameters before the
fourth. `warm_steps` more follow before the window.
"""

import gc

import numpy as np
import torch

import reference
from harness import check, synth, weights
from harness.trace import Marks


class Job:
    def __init__(self, run):
        self.run, self.cfg, self.tr = run, run.cfg, run.traffic
        self.dev = torch.device(run.device)
        self.on_card = self.dev.type == "cuda"

    # ---------------------------------------------------------- set-up
    def _pool(self):
        from resuneta_torch.data import ArrayDataset

        tr, dev = self.tr, self.dev
        gen = weights.generator(self.run.seed, "pool", dev)
        n, P = tr["pool"], tr["patch"]
        if tr["input"] == "rgb_u8":
            ids = torch.empty((n, P, P), dtype=torch.uint8, device=dev)
            img = torch.empty((n, P, P, 3), dtype=torch.uint8, device=dev)
            cells = tr["cell_px"]
            for k, c in enumerate(cells):
                idx = torch.arange(k, n, len(cells), device=dev)
                cid, reg = synth.voronoi(len(idx), P, P, c,
                                         tr["class_share"], gen, dev)
                ids[idx] = cid
                img[idx] = synth.rgb(cid, reg, gen, dev)
            aug = torch.randint(0, 5, (n,), generator=gen, device=dev)
            arrays = {"image_u8": img.cpu().numpy(),
                      "label_ids": ids.cpu().numpy(),
                      "aug": aug.cpu().numpy().astype(np.int32)}
        else:
            image, onehot = synth.amazon(n, P, tr["bands"], tr["share_def"],
                                         tr["share_past"], gen, dev)
            arrays = {"image": image.cpu().numpy(),
                      "seg": onehot.cpu().numpy()}
        return ArrayDataset(arrays)

    def _order(self):
        rng = np.random.default_rng(weights.stream_seed(self.run.seed,
                                                        "order"))
        n, B = self.tr["pool"], self.tr["batch"]
        while True:
            perm = rng.permutation(n)
            for b in range(n // B):
                yield perm[b * B:(b + 1) * B]

    def _step_fn(self):
        from resuneta_torch import losses
        from resuneta_torch.data import (make_device_pipeline,
                                         make_label_head_pipeline)
        from resuneta_torch.train import make_train_step

        cfg, dev = self.cfg, self.dev
        if cfg["loss"] == "tanimoto":
            fns = losses.make_losses("tanimoto")
        else:
            wce = losses.weighted_categorical_crossentropy(
                cfg["class_weights"])
            fns = {h: wce for h in cfg["loss_weights"]}
        if self.tr["input"] == "rgb_u8":
            pre = make_device_pipeline(cfg["num_classes"], cfg["norm_type"],
                                       True, cfg["color_head"], device=dev)
        else:
            pre = make_label_head_pipeline(dev)
        return make_train_step(fns, cfg["loss_weights"], True,
                               preprocess=pre, device=dev)

    def _adam_grad_norms(self):
        """The first step's gradient norms, from Adam's state after it."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        return torch.stack([opt.state[p]["exp_avg"].float().norm() / (1 - b1)
                            for _, p in self.names_params])

    def setup(self, hook=None):
        mark = Marks()
        from resuneta_torch.models import ResUnetA
        from resuneta_torch.train import create_train_state

        cfg, dev = self.cfg, self.dev
        if self.on_card:
            from resuneta_torch.kernels import build
            build.build_all()
        mark("kernels")
        dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else \
            torch.float32
        with torch.device("meta"):
            model = ResUnetA(cfg["num_classes"], img_size=cfg["img_size"],
                             multitasking=True, color_head=cfg["color_head"],
                             dtype=dtype, in_channels=cfg["in_channels"],
                             device="meta")
        mark("imports")
        model = model.to_empty(device=dev)
        mark("context")
        model.load_state_dict(weights.make(cfg, self.run.seed, dev))
        self.state = create_train_state(model, "adam", cfg["learning_rate"])
        self.names_params = list(model.named_parameters())
        mark("model")
        self.ds = self._pool()
        mark("pool")
        self.order = self._order()
        self.step = self._step_fn()
        if hook is not None:
            hook(self)
        self.first, first_rows = [], []
        for b in range(self.tr["first_steps"]):
            pos = next(self.order)
            self.first.append(pos)
            self.state, row = self.step(self.state, self.ds.get_batch(pos))
            first_rows.append(row)
            if b == 0:
                grad_norms = self._adam_grad_norms()
        mark("first_steps")
        self.after = {k: p.detach().to("cpu", copy=True)
                      for k, p in self.names_params}
        self.first_losses = [float(r[0]) for r in first_rows]
        self.grad_norms = dict(zip([k for k, _ in self.names_params],
                                   grad_norms.cpu().tolist()))
        for _ in range(self.tr["warm_steps"]):
            self.state, _ = self.step(self.state,
                                      self.ds.get_batch(next(self.order)))
        self._sync()
        mark("warm_steps")
        self.phases = mark.seconds

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    # ---------------------------------------------------------- window
    def _one(self, spans, rows):
        pos = next(self.order)
        with spans("loader.get_batch"):
            raw = self.ds.get_batch(pos)
        with spans("train.step"):
            self.state, row = self.step(self.state, raw)
        rows.append(row)

    def window(self, seconds, spans):
        import time

        rows, events = [], []
        t0 = time.perf_counter()
        while True:
            if self.on_card:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            self._one(spans, rows)
            if time.perf_counter() - t0 >= seconds:
                break
        if self.on_card:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        self._sync()
        elapsed = time.perf_counter() - t0
        losses = torch.stack([r[0] for r in rows]).cpu()
        out = {"attempted": len(rows),
               "failed": int((~torch.isfinite(losses)).sum()),
               "units": len(rows), "window_s": elapsed,
               "train_patches_per_s": len(rows) * self.tr["batch"] / elapsed}
        if events:
            gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            out["train_step_p90_ms"] = float(np.percentile(gaps, 90))
        return out

    def traced(self, spans):
        rows = []
        for _ in range(self.tr["trace_steps"]):
            self._one(spans, rows)
        self.trace_units = len(rows)

    def release(self):
        del self.state, self.step, self.names_params
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- check
    def _reference(self, mode, rows=None):
        raws = [self.ds.get_batch(p[:rows]) for p in self.first]
        return reference.train_steps(self.cfg, self.w0, raws, mode=mode,
                                     device=self.dev)

    def check(self):
        self.w0 = weights.make(self.cfg, self.run.seed, self.dev)
        change = {k: float((v.to(self.dev) - self.w0[k]).norm())
                  for k, v in self.after.items()}
        self.ref = self._reference("f32")
        prog = {"losses": self.first_losses, "grad_norms": self.grad_norms,
                "change_norms": change}
        numbers, self.worst = check.train_numbers(prog, self.ref)
        return numbers

    def control(self, mode):
        """The reference put in the program's place, against the f32
        reference (after check()): in a lower precision (`mode` one of
        reference.precision.MODES), or with the fault "half" (half of each
        batch left out, the mean taken over the rest)."""
        if mode == "half":
            return check.train_numbers(
                self._reference("f32", self.tr["batch"] // 2), self.ref)[0]
        return check.train_numbers(self._reference(mode), self.ref)[0]
