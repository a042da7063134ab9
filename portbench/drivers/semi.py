"""The semi-supervised cells (`SemiTrainer` with its hooks and EMA teacher).

A step trains the student on each valid labeled slice and on the two views
(plain and flipped) of each valid unlabeled one. The checked steps take
labeled and unlabeled batches of distinct training slices drawn by the
benchmark's generator (every synthetic slice has a label map), and
augmentation draws of the configuration's label policy: one view of the
labeled batch, one geometry shared by both views of the unlabeled batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .base import TrainerCell
from .pretrain import draw_flip, draw_geometry, draw_jitter


class Cell(TrainerCell):
    pretrain = False

    def loaders(self) -> List:
        return [self.trainer._labeled_loader, self.trainer._unlabeled_loader]

    def views(self, rows: Sequence[np.ndarray]) -> int:
        return int((np.asarray(rows[0]) >= 0).sum()) + 2 * int((np.asarray(rows[1]) >= 0).sum())

    def call(self, inputs, params: Optional[Dict] = None) -> Dict:
        return self.trainer._train_step(inputs[0], inputs[1], self.trainer._generator,
                                        self.scalars, params=params)

    def losses(self, metrics: Dict) -> Dict[str, torch.Tensor]:
        return {"sup_loss": metrics["sup_loss"], "reg_loss": metrics["reg_loss"]}

    def check_rows(self, rng: np.random.Generator, step: int) -> List[np.ndarray]:
        n_l = int(self.program["LabeledLoader"]["batch_size"])
        n_u = int(self.program["UnlabeledLoader"]["batch_size"])
        picks = rng.choice(len(self.train_set), size=n_l + n_u, replace=False)
        return [picks[:n_l].astype(np.int64), picks[n_l:].astype(np.int64)]

    def _view(self, gen, n: int, aug: Dict) -> Dict:
        out = {"geo": draw_geometry(gen, n, aug, int(self.config["data"]["canvas"]), self.device)}
        if aug["jitter"]:
            out["jitter"] = draw_jitter(gen, n, aug, self.device)
        return out

    def check_params(self, gen: torch.Generator, rows) -> Dict:
        aug = self.config["augment"]["label"]
        lab = self._view(gen, len(rows[0]), aug)
        unl = self._view(gen, len(rows[1]), aug)
        pair = {"geo1": unl["geo"], "geo2": unl["geo"]}
        if aug["jitter"]:
            pair["jitter1"] = unl["jitter"]
            pair["jitter2"] = draw_jitter(gen, len(rows[1]), aug, self.device)
        return {"lab": lab, "unl": pair,
                "flip": draw_flip(gen, len(rows[1]), float(aug["flip_threshold"]), self.device)}
