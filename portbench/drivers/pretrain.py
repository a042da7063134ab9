"""The contrastive encoder-pretrain cells (`PretrainEncoderTrainer`, the
monolithic step or, with `Trainer.grad_cache`, the gradient cache's).

A step trains on the two views of every valid row of its contrastive batch.
The checked steps draw their batches as the contrast sampler does, from the
benchmark's generator: `scan_sample_num` scans without replacement, then
`partition_sample_num` slices of each partition of each, no slice twice in
a batch. Their augmentation draws follow the pretrain policy of the
configuration's `augment` block.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .base import TrainerCell


def draw_geometry(gen: torch.Generator, n: int, policy: Dict, canvas: int, device) -> Dict:
    """One view's geometry in the program's draw format, over full-canvas
    slices: rotation in +-rot_degrees, flips at p = 0.5 where the policy flips,
    crop offsets uniform over the canvas."""
    u = torch.rand((5, n), generator=gen, device=device)
    deg = float(policy["rot_degrees"])
    full = torch.full((n,), float(canvas), device=device)
    span = canvas - int(policy["crop"]) + 1
    return {"theta": (u[0] * 2 * deg - deg) * (math.pi / 180.0),
            "fh": (u[1] < 0.5) & bool(policy["hflip"]),
            "fv": (u[2] < 0.5) & bool(policy["vflip"]),
            "cy": torch.floor(u[3] * span), "cx": torch.floor(u[4] * span),
            "rh": full, "rw": full, "oh": full, "ow": full}


def draw_jitter(gen: torch.Generator, n: int, policy: Dict, device):
    u = torch.rand((2, n), generator=gen, device=device)
    (b0, b1), (c0, c1) = policy["brightness"], policy["contrast"]
    return u[0] * (b1 - b0) + b0, u[1] * (c1 - c0) + c0


def draw_flip(gen: torch.Generator, n: int, threshold: float, device) -> Dict:
    u = torch.rand((2, n), generator=gen, device=device)
    return {"fh": u[0] < threshold, "fv": u[1] < threshold}


class Cell(TrainerCell):
    pretrain = True

    def loaders(self) -> List:
        return [self.trainer._contrastive_loader]

    def views(self, rows: Sequence[np.ndarray]) -> int:
        return 2 * int((np.asarray(rows[0]) >= 0).sum())

    def call(self, inputs, params: Optional[Dict] = None) -> Dict:
        return self.trainer._train_step(inputs[0], self.trainer._generator, self.scalars,
                                        params=params)

    def losses(self, metrics: Dict) -> Dict[str, torch.Tensor]:
        return {"reg_loss": metrics["reg_loss"]}

    def check_rows(self, rng: np.random.Generator, step: int) -> List[np.ndarray]:
        cl = self.program["ContrastiveLoaderParams"]
        scans, per = int(cl["scan_sample_num"]), int(cl["partition_sample_num"])
        names = np.asarray([s.rsplit("_", 1)[0] for s in self.train_set.filenames])
        unique = np.unique(names)
        picks = []
        for scan in rng.choice(unique, size=scans, replace=False):
            for part in range(3):
                pool = np.flatnonzero((names == scan) & (self.partitions == part))
                picks.extend(rng.choice(pool, size=per, replace=False).tolist())
        return [np.asarray(picks, np.int64)]

    def check_params(self, gen: torch.Generator, rows) -> Dict:
        n = len(rows[0])
        aug = self.config["augment"]["pretrain"]
        canvas = int(self.config["data"]["canvas"])
        g1 = draw_geometry(gen, n, aug, canvas, self.device)
        g2 = draw_geometry(gen, n, aug, canvas, self.device)
        return {"aug": {"geo1": g1, "geo2": g2,
                        "jitter1": draw_jitter(gen, n, aug, self.device),
                        "jitter2": draw_jitter(gen, n, aug, self.device)},
                "flip": draw_flip(gen, n, float(aug["flip_threshold"]), self.device)}
