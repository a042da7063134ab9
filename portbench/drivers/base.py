"""What every cell's driver shares: the program's trainer built from the
configuration and the traffic, the benchmark's weights put into it, and the
epochs of steps that `start_training` would run.

A driver builds the trainer with `spcl_torch.entry.build_trainer` on the
benchmark's datasets (in memory, in place of the packed `.npz` files) and
calls `init()`. It then copies the benchmark's weights into the model, the
hooks' projectors and the EMA teacher, and sets the epoch at which the
traffic starts the run.

Steps run as `start_training` runs them, from the trainer's own parts: an
epoch draws its `num_batches` index vectors from the trainer's samplers and
uploads them once, each step calls the trainer's step on its vector, and an
epoch ends with the one drain of the step metrics, the trainer's epoch
statistics and the hooks' schedulers. No checkpoint is written.

The checked steps go through the same call with index vectors and
augmentation draws the benchmark makes itself (`params=`), so that the
reference can be handed the same.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence
from unittest import mock

import numpy as np
import torch

from .. import data as bench_data


def deep_merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def acdc_partitions(stems: Sequence[str], parts: int = 3) -> np.ndarray:
    """The ACDC partition of each slice (contrastyou's rule): cut = len // 3;
    slice index <= cut - 1 -> 0, <= 2 cut -> 1, else 2."""
    scans: Dict[str, int] = {}
    for s in stems:
        scans[s.rsplit("_", 1)[0]] = scans.get(s.rsplit("_", 1)[0], 0) + 1
    out = []
    for s in stems:
        cut = scans[s.rsplit("_", 1)[0]] // parts
        i = int(s.rsplit("_", 1)[1])
        out.append(0 if i <= cut - 1 else (1 if i <= 2 * cut else 2))
    return np.asarray(out, np.int64)


# per-slice answers a step returns beside its losses (the labeled view's
# Dice statistics of its argmax prediction)
ANSWERS = ("inter", "union")


# faults planted under the timed path, for the tests and the readings:
# `frozen` (the optimizer leaves the state unchanged), `half` (the second half
# of each batch is left out: its rows are padding, the mean runs over the
# rest), `altered` (the loss a step returns is 10% off)
FAULTS = ("frozen", "half", "altered")


class TrainerCell:
    """One cell of a configuration that trains through a `spcl_torch` trainer."""

    #: built as a pretrain trainer (`build_trainer(pretrain=...)`)
    pretrain = False

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, save_dir: str,
                 fault: Optional[str] = None):
        from spcl_torch.entry import common
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.program = deep_merge(config["program"], traffic.get("program", {}))
        self.program["RandomSeed"] = self.seed
        train, test = bench_data.make_datasets(config["data"], self.seed, self.device)
        self.train_set = train
        self.partitions = acdc_partitions(train.filenames)
        with mock.patch.object(common, "load_datasets_from_config",
                               lambda cfg: (train, test)):
            self.trainer = common.build_trainer(self.program, save_dir=save_dir,
                                                pretrain=self.pretrain, device=self.device)
        self.trainer.init()
        self.weights = bench_data.make_weights(self.weight_specs(), self.seed, self.device)
        self._load_weights()
        self.trainer._cur_epoch = int(traffic["window_epoch"])
        self.epoch_steps = 0
        self.num_batches = int(self.trainer._num_batches)
        self.failed = 0
        self.epoch_open = False
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")

    # ---------------------------------------------------------------- weights
    def named_leaves(self) -> Dict[str, torch.Tensor]:
        """{name: parameter} of everything the benchmark's weights fill: the
        model's parameters, and the hook projector's under `head.`."""
        out = dict(self.trainer.model.named_parameters())
        heads = [h for h in self.trainer.hooks if h.projector is not None]
        if len(heads) > 1:
            raise NotImplementedError("one projector head at most")
        for h in heads:
            out.update({f"head.{k}": v for k, v in h.projector.named_parameters()})
        return out

    def weight_specs(self):
        return [(k, tuple(v.shape)) for k, v in self.named_leaves().items()]

    @torch.no_grad()
    def _load_weights(self) -> None:
        for name, p in self.named_leaves().items():
            p.copy_(self.weights[name])
        teacher = self.trainer.teacher
        if teacher is not None:
            for name, p in teacher.model.named_parameters():
                p.copy_(self.weights[name])

    def optimized(self) -> Dict[str, torch.Tensor]:
        """{name: parameter} of the leaves the optimizer updates, in its order."""
        ids = {id(p): k for k, p in self.named_leaves().items()}
        return {ids[id(p)]: p for g in self.trainer._optimizer.param_groups
                for p in g["params"]}

    # ---------------------------------------------------------------- kind
    def loaders(self) -> List:
        raise NotImplementedError

    def views(self, rows: Sequence[np.ndarray]) -> int:
        raise NotImplementedError

    def call(self, inputs: Sequence[torch.Tensor], params: Optional[Dict] = None) -> Dict:
        raise NotImplementedError

    def check_rows(self, rng: np.random.Generator, step: int) -> List[np.ndarray]:
        raise NotImplementedError

    def check_params(self, gen: torch.Generator, rows: Sequence[np.ndarray]) -> Dict:
        raise NotImplementedError

    def losses(self, metrics: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    # ---------------------------------------------------------------- epochs
    def begin_epoch(self) -> None:
        tr = self.trainer
        self.scalars = tr._hook_scalars()
        self.lr = tr._set_epoch_lr()
        self.rows = [tr._index_rows(loader, self.num_batches) for loader in self.loaders()]
        self.inputs = [tr._step_inputs(loader, r) for loader, r in zip(self.loaders(), self.rows)]
        self.pending, self.global_rows, self.n_views = [], [], 0
        self.epoch_steps = 0
        self.epoch_open = True

    def _run(self, inputs, params, global_rows, views) -> Dict:
        if self.fault == "half":
            inputs = [torch.cat([x[: len(x) // 2], torch.full_like(x[len(x) // 2:], -1)])
                      for x in inputs]
        metrics = self.call(inputs, params)
        if self.fault == "altered":
            metrics = dict(metrics)
            for k in self.losses(metrics):
                metrics[k] = metrics[k] * 1.1
        self.pending.append(metrics)
        self.global_rows.append(global_rows)
        self.n_views += views
        self.epoch_steps += 1
        return metrics

    def step(self) -> int:
        """One step of the epoch (a new epoch first when this one is done);
        returns the views it trains on."""
        if not self.epoch_open or self.epoch_steps >= self.num_batches:
            if self.epoch_open:
                self.end_epoch()
            self.begin_epoch()
        k = self.epoch_steps
        rows = [r[k] for r in self.rows]
        views = self.views(rows)
        self._run([x[k] for x in self.inputs], None,
                  self.loaders()[0].dataset.to_global(rows[0]), views)
        return views

    def checked_step(self, rows: Sequence[np.ndarray], params: Dict) -> Dict:
        """A step on the benchmark's global index vectors and draws."""
        if not self.epoch_open:
            self.begin_epoch()
        inputs = [torch.as_tensor(r, dtype=torch.int64).to(self.device) for r in rows]
        return self._run(inputs, params, np.asarray(rows[0]), self.views(rows))

    def end_epoch(self) -> None:
        """The drain of the epoch's step metrics, the trainer's epoch
        statistics and the hooks' schedulers, as `start_training` runs them."""
        from spcl_torch.training import deferred
        tr = self.trainer
        # "elapsed" feeds only the trainer's own throughput meter: the
        # benchmark times the window itself
        record = {"epoch": tr._cur_epoch, "lr": self.lr, "n_slices": self.n_views,
                  "elapsed": 1.0, "steps": len(self.pending), "rows": self.global_rows,
                  "metrics": tr._stack_metrics(self.pending), "matrices": None}
        host = deferred.drain([record])[0]
        losses = [np.asarray(host["metrics"][k]) for k in self.losses(self.pending[0])]
        bad = np.zeros(len(self.pending), bool)
        for v in losses:
            bad |= ~np.isfinite(v.reshape(len(self.pending), -1)).all(axis=1)
        self.failed += int(bad.sum())
        if not bad.any():
            tr._epoch_stats(record, host)
        for h in tr.hooks:
            h.on_epoch_end()
        tr._cur_epoch += 1
        self.epoch_open = False

    def close(self) -> None:
        self.trainer._writer.close()

    # ---------------------------------------------------------------- checks
    def run_checked(self, steps: int) -> Dict:
        """The checked steps, from the seed: the benchmark's own index vectors
        and draws through the window's call. Returns the program's results:
        each step's losses and per-slice answers, the first gradient as the
        optimizer took it (its first moment after one step over 1 - b1), and
        the leaves after the last checked step (the teacher's too), all
        copied to the host."""
        rng = np.random.default_rng(self.seed + 2)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed + 3) % (2 ** 63))
        opt = self.trainer._optimizer
        leaves = self.optimized()
        b1 = opt.param_groups[0]["betas"][0]
        saved_step = opt.step
        if self.fault == "frozen":
            opt.step = lambda closure=None: None
        feeds, losses, answers, first = [], [], [], None
        try:
            for s in range(steps):
                rows = self.check_rows(rng, s)
                params = self.check_params(gen, rows)
                feeds.append({"rows": [np.asarray(r) for r in rows], "params": _to_host(params)})
                metrics = self.checked_step(rows, params)
                losses.append({k: float(v) for k, v in self.losses(metrics).items()})
                answers.append({k: metrics[k].detach().cpu() for k in ANSWERS if k in metrics})
                if s == 0:
                    first = {k: (opt.state[p]["mu"] / (1.0 - b1)).cpu() if p in opt.state
                             and "mu" in opt.state[p] else torch.zeros_like(p).cpu()
                             for k, p in leaves.items()}
        finally:
            opt.step = saved_step
        after = {k: p.detach().cpu().clone() for k, p in leaves.items()}
        teacher = self.trainer.teacher
        if teacher is not None:
            after.update({f"teacher.{k}": p.detach().cpu().clone()
                          for k, p in teacher.model.named_parameters() if k in leaves})
        return {"feeds": feeds, "losses": losses, "answers": answers,
                "first_grad": first, "after": after}

    def reference_inputs(self) -> Dict:
        """What the reference is handed: the benchmark's weights and data."""
        return {"weights": {k: v.detach().cpu() for k, v in self.weights.items()},
                "images": self.train_set.images, "labels": self.train_set.labels,
                "partitions": self.partitions}


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    return tree
