"""Whole-tile segmentation traffic: one client in a closed loop sends
`tile` x `tile` uint8 RGB tiles back to back, each through
`predict_scene(make_seg_ids_fn(model, norm_type=<the configuration's>),
tile, patch, batch_size=batch, ids_only=True)`, the test CLI's production
path: the non-overlapping chop on the host, uint8 batches uploaded and
normalised on the card, the forward in eval mode, the argmax on the card,
uint8 ids back, the row-major reconstruction on the host.

`tiles` distinct tiles of seeded Voronoi class maps (regions of `cell_px`
pixels, classes drawn with `class_share`) are made in set-up, kept in host
memory and cycled; `warm_tiles` tiles go through before the window. The
weights are the seeded ones with BatchNorm running statistics taken by the
reference from `bn_patches` seeded patches of the first tile.

For the output check, the window keeps of each finished tile the class
map's crops of `check_patches` patch positions drawn from the seed for
that tile's turn; after the window `check_tiles` of the finished turns
are drawn from the seed, and the reference computes those patches of
the tile again, from the raw pixels.
"""

import gc
import time

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
        P, T = self.tr["patch"], self.tr["tile"]
        self.grid = (T // P, T // P)
        self.out_px = (T // P * P) ** 2

    def _tiles(self):
        tr, dev = self.tr, self.dev
        gen = weights.generator(self.run.seed, "tiles", dev)
        T = tr["tile"]
        ids, reg = synth.voronoi(tr["tiles"], T, T, tr["cell_px"],
                                 tr["class_share"], gen, dev)
        img = synth.rgb(ids, reg, gen, dev)
        return [t.cpu().numpy() for t in img]

    def _weights(self):
        """The seeded weights, with BatchNorm running statistics of a
        train-mode forward of `bn_patches` seeded patches of the first tile
        (the reference's, in float32), as a trained model's: with running
        mean 0 and variance 1 the eval model's class map is near one class
        on some seeds, so that no pixel lies near a tie for the check to
        read."""
        w = weights.make(self.cfg, self.run.seed, self.dev)
        if not hasattr(self, "bn_stats"):
            rng = np.random.default_rng(weights.stream_seed(self.run.seed,
                                                            "bn"))
            n = self.grid[0] * self.grid[1]
            P = self.tr["patch"]
            x = []
            for k in sorted(rng.choice(n, self.tr["bn_patches"],
                                       replace=False)):
                r, c = divmod(int(k), self.grid[1])
                x.append(self.tiles[0][r * P:(r + 1) * P, c * P:(c + 1) * P])
            x = torch.from_numpy(np.stack(x)).float() / 255.0
            stats = reference.bn_statistics(self.cfg, w, x, device=self.dev)
            self.bn_stats = {k: (m.cpu(), v.cpu())
                             for k, (m, v) in stats.items()}
        for k, (m, v) in self.bn_stats.items():
            w[f"{k}.mean"] = m.to(self.dev)
            w[f"{k}.var"] = v.to(self.dev)
        return w

    def setup(self, hook=None):
        mark = Marks()
        from resuneta_torch.infer.sliding import make_seg_ids_fn
        from resuneta_torch.models import ResUnetA

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
        self.tiles = self._tiles()
        mark("tiles")
        model.load_state_dict(self._weights())
        self.model = model.eval()
        self.fn = make_seg_ids_fn(model, multitask=True,
                                  norm_type=cfg["norm_type"], device=dev)
        mark("model")
        if hook is not None:
            hook(self)
        for i in range(self.tr["warm_tiles"]):
            self._predict(self.tiles[i % len(self.tiles)])
        mark("warm_tiles")
        self.phases = mark.seconds
        self.turn = 0
        self.kept = []

    def _predict(self, tile):
        from resuneta_torch.infer.sliding import predict_scene

        class_map, _ = predict_scene(self.fn, tile, self.tr["patch"],
                                     batch_size=self.tr["batch"],
                                     multitask=True, ids_only=True)
        return class_map

    def _positions(self, turn):
        rng = np.random.default_rng(
            [weights.stream_seed(self.run.seed, "crops"), turn])
        n = self.grid[0] * self.grid[1]
        return sorted(rng.choice(n, self.tr["check_patches"], replace=False))

    def _one(self, spans):
        turn = self.turn
        with spans("scene.predict"):
            class_map = self._predict(self.tiles[turn % len(self.tiles)])
        P = self.tr["patch"]
        crops = {}
        for k in self._positions(turn):
            r, c = divmod(int(k), self.grid[1])
            crops[int(k)] = class_map[r * P:(r + 1) * P,
                                      c * P:(c + 1) * P].copy()
        self.kept.append((turn, crops))
        self.turn += 1

    def window(self, seconds, spans):
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._one(spans)
            n += 1
        elapsed = time.perf_counter() - t0
        return {"attempted": n, "failed": 0, "units": n, "window_s": elapsed,
                "scene_mpix_per_s": n * self.out_px / elapsed / 1e6}

    def traced(self, spans):
        for _ in range(self.tr["trace_tiles"]):
            self._one(spans)
        self.trace_units = self.tr["trace_tiles"]

    def release(self):
        del self.fn, self.model
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- check
    def _sample(self):
        """The checked (turn, crops) of the finished tiles, drawn from the
        seed, and the raw patches they came from."""
        rng = np.random.default_rng(weights.stream_seed(self.run.seed,
                                                        "check"))
        pick = rng.choice(len(self.kept), min(self.tr["check_tiles"],
                                              len(self.kept)), replace=False)
        P = self.tr["patch"]
        patches, ids = [], []
        for i in sorted(pick):
            turn, crops = self.kept[i]
            tile = self.tiles[turn % len(self.tiles)]
            for k, crop in crops.items():
                r, c = divmod(k, self.grid[1])
                patches.append(tile[r * P:(r + 1) * P, c * P:(c + 1) * P])
                ids.append(crop)
        return np.stack(patches), np.stack(ids)

    def _logits(self, patches, mode):
        x = torch.from_numpy(patches).float() / 255.0
        return reference.eval_logits(self.cfg, self.w0, x, mode=mode,
                                     device=self.dev)

    def check(self):
        if self.cfg["norm_type"] != 1:
            raise ValueError("the scene check normalises as norm_type 1")
        self.w0 = self._weights()
        self.patches, ids = self._sample()
        self.ref = self._logits(self.patches, "f32")
        # the rounding the configuration's bf16 products allow, the scale
        # of the gaps: the seeded weights set the logits' size
        low = self._logits(self.patches, "bf16")
        self.rounding = float((low - self.ref).abs().max())
        del low
        return check.scene_numbers(self.ref, ids, self.rounding)

    def control(self, mode):
        ctrl = self._logits(self.patches, mode).argmax(dim=-1)
        return check.scene_numbers(self.ref, ctrl, self.rounding)
