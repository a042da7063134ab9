"""Encoder-pretrain trainer: the outer epoch loop around the pretrain step.

The counterpart of `spcl_tpu/training/trainer.py::PretrainEncoderTrainer`
(trainer.py:1110-1265; reference new_pretrain.py:18-110):

- `init()` moves the UNet and the hooks' projectors to the device, freezes
  the stages outside `set_trainable_stages` (no update, no weight decay),
  and builds RAdam over the trainable parameters and the projectors;
- each epoch reads gamma from the hooks' `epoch_scalars`, sets the epoch's
  learning rate (warmup x multiplier -> cosine, per epoch), runs
  `num_batches` steps on host batches of the contrastive loader copied to
  the device, then drains the metrics once: `reg_loss` plus each hook's
  `sp_weight` / `age_param` meters, failing fast on a non-finite loss;
- `last.ckpt` every `Trainer.save_every` epochs and at the last epoch, then
  the hooks' `on_epoch_end`.

Randomness inside the steps comes from one `torch.Generator` on the device,
seeded from the config's RandomSeed.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .checkpoint import load_model_state_dict, save_checkpoint
from .optim import build_optimizer
from .steps import batch_to_device, build_pretrain_step
from ..data.augment import POLICY_ZOO, AugmentPolicy
from ..data.loader import HostLoader
from ..hooks.base import TrainerHook, get_individual_hooks
from ..meters import AverageValueMeter, MeterInterface, meter_display
from ..models.masking import set_trainable_stages
from ..models.unet import UNet
from ..schedulers.lr import warmup_cosine_epoch_schedule
from ..utils.utils import get_logger

logger = get_logger("trainer")


class PretrainEncoderTrainer:
    """Contrastive encoder pretraining: loss = hook regularizers only, no
    eval, `last.ckpt` per `save_every` epochs."""
    total_freedom = True  # independent geometry per view
    policy_kind = "pretrain"
    train_meter_focus = "tra"

    def __init__(self, *, model: UNet, contrastive_loader: HostLoader, save_dir: str,
                 max_epoch: int = 100, num_batches: int = 100,
                 config: Optional[Dict] = None, seed: int = 10, crop: int = 224,
                 data_name: str = "acdc", forward_until: Optional[str] = None,
                 device="cuda"):
        self._model = model
        self._contrastive_loader = contrastive_loader
        self._save_dir = str(save_dir)
        self._max_epoch = int(max_epoch)
        self._num_batches = int(num_batches)
        self._config = config or {}
        self._seed = int(seed)
        self._crop = int(crop)
        self._data_name = data_name
        self._forward_until = forward_until
        self._device = torch.device(device)
        self._hooks: List[TrainerHook] = []
        self._trainable_stages: Optional[List[str]] = None
        self._cur_epoch = 0
        self._initialized = False
        # one entry per step, host floats: {"epoch", "reg_loss", "hooks"}
        self.step_metrics: List[Dict] = []
        self.last_epoch_stats: Dict = {}

    # ----------------------------------------------------------------- registration
    def register_hooks(self, *hooks: TrainerHook) -> None:
        if self._initialized:
            raise RuntimeError("register_hooks must be called before init()")
        self._hooks.extend(get_individual_hooks(*hooks))

    def set_trainable_stages(self, stages: Sequence[str]) -> None:
        """`set_grad` (reference arch/unet.py:242-259): only these stages train."""
        self._trainable_stages = list(stages)

    @property
    def train_policy(self) -> AugmentPolicy:
        policy = POLICY_ZOO[self._data_name][self.policy_kind]
        if policy.crop != self._crop:
            # keep resize targets self-similar under a crop override
            resize = policy.resize
            if resize == policy.crop:
                resize = self._crop
            elif resize == (policy.crop, policy.crop):
                resize = (self._crop, self._crop)
            policy = dataclasses.replace(policy, crop=self._crop, resize=resize)
        return policy

    # ----------------------------------------------------------------- init
    def init(self) -> None:
        self._model.to(self._device)
        ckpt = (self._config.get("Arch") or {}).get("checkpoint")
        if ckpt:
            self._model.load_state_dict(load_model_state_dict(ckpt), strict=False)
            logger.info("warm-started model weights from %s", ckpt)
        if self._trainable_stages is not None:
            set_trainable_stages(self._model, self._trainable_stages)
        for h in self._hooks:
            h.build(self._model, self._device)

        optim_cfg = dict(self._config.get("Optim", {}))
        base_lr = float(optim_cfg.get("lr", 1e-7))
        sched_cfg = self._config.get("Scheduler")
        if sched_cfg:
            self._lr_schedule = warmup_cosine_epoch_schedule(
                base_lr=base_lr, multiplier=float(sched_cfg.get("multiplier", 300)),
                warmup_max=int(sched_cfg.get("warmup_max", 10)),
                max_epoch=self._max_epoch, steps_per_epoch=self._num_batches)
        else:
            self._lr_schedule = lambda step: base_lr
        params = [p for p in self._model.parameters() if p.requires_grad]
        for h in self._hooks:
            params.extend(h.parameters())
        self._optimizer = build_optimizer(
            params, name=optim_cfg.get("name", "RAdam"), lr=self._lr_schedule(0),
            weight_decay=float(optim_cfg.get("weight_decay", 0.0)))
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(self._seed)
        self._train_step = build_pretrain_step(
            self._model, self._hooks, self._optimizer, policy=self.train_policy,
            total_freedom=self.total_freedom, until=self._forward_until)
        self._initialized = True

    # ----------------------------------------------------------------- epochs
    def _hook_scalars(self) -> Dict[str, Dict[str, float]]:
        # _cur_epoch is 1-based; epoch e uses the scheduler value at e-1
        # (reference semi_seg/hooks/infonce.py:133-136), as spcl_tpu does
        return {h.name: h.epoch_scalars(self._cur_epoch - 1) for h in self._hooks}

    def _epoch_lr(self) -> float:
        return float(self._lr_schedule(max(self._cur_epoch - 1, 0) * self._num_batches))

    def _synchronize(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _run_train_epoch(self) -> Dict:
        meters = MeterInterface(default_focus=self.train_meter_focus)
        with meters.focus_on(self.train_meter_focus):
            meters.register_meter("lr", AverageValueMeter())
            meters.register_meter("reg_loss", AverageValueMeter())
        scalars = self._hook_scalars()
        lr = self._epoch_lr()
        for group in self._optimizer.param_groups:
            group["lr"] = lr
        it = iter(self._contrastive_loader)
        pending = []
        n_slices = 0
        self._synchronize()
        t0 = time.perf_counter()
        for _ in range(self._num_batches):
            batch = batch_to_device(next(it), self._device)
            n_slices += 2 * batch["image"].shape[0]
            pending.append(self._train_step(batch, self._generator, scalars))
        self._synchronize()
        elapsed = time.perf_counter() - t0
        # one device -> host copy per epoch: no per-step synchronisation
        reg = torch.stack([m["reg_loss"] for m in pending]).cpu().numpy()
        hook_vals = {name: {k: torch.stack([torch.as_tensor(m["hooks"][name][k],
                                                            device=self._device)
                                            for m in pending]).cpu().numpy()
                            for k in pending[0]["hooks"][name]}
                     for name in pending[0]["hooks"]}
        for b in range(len(pending)):
            # fail fast on NaN like the reference criterion (contrast_loss3.py:108)
            if not np.isfinite(reg[b]):
                raise RuntimeError(f"non-finite pretrain reg_loss at batch {b}: {reg[b]}")
            record = {"epoch": self._cur_epoch, "reg_loss": float(reg[b]),
                      "hooks": {n: {k: float(v[b]) for k, v in hv.items()}
                                for n, hv in hook_vals.items()}}
            self.step_metrics.append(record)
            with meters.focus_on(self.train_meter_focus):
                meters["reg_loss"].add(record["reg_loss"])
            for name, hm in record["hooks"].items():
                with meters.focus_on(name):
                    for k, v in hm.items():
                        if k not in meters:
                            meters.register_meter(k, AverageValueMeter())
                        meters[k].add(v)
        with meters.focus_on(self.train_meter_focus):
            meters["lr"].add(lr)
        stats = meters.statistics()
        stats.setdefault(self.train_meter_focus, {})["throughput"] = {
            "slices_per_sec": n_slices / max(elapsed, 1e-9),
            "steps_per_sec": len(pending) / max(elapsed, 1e-9)}
        return stats

    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        save_every = int((self._config.get("Trainer") or {}).get("save_every", 1))
        for self._cur_epoch in range(start, self._max_epoch + 1):
            train_stats = self._run_train_epoch()
            self.last_epoch_stats = train_stats
            if (self._cur_epoch % max(save_every, 1) == 0
                    or self._cur_epoch == self._max_epoch):
                self.save_to("last.ckpt")
            for h in self._hooks:
                h.on_epoch_end()
            logger.info("pretrain epoch %03d | %s", self._cur_epoch,
                        meter_display(train_stats))
        from .. import success
        success(self._save_dir)
        return 0.0

    # ----------------------------------------------------------------- io
    def save_to(self, save_name: str) -> None:
        save_checkpoint(str(Path(self._save_dir) / save_name), {
            "_model": self._model.state_dict(),
            "_hooks": {h.name: h.projector.state_dict() for h in self._hooks
                       if h.projector is not None},
            "_hook_states": {h.name: h.state_dict() for h in self._hooks},
            "_optimizer": self._optimizer.state_dict(),
            "cur_epoch": self._cur_epoch,
        })

    @property
    def save_dir(self) -> str:
        return self._save_dir

    @property
    def model(self) -> UNet:
        return self._model

    @property
    def hooks(self) -> List[TrainerHook]:
        return list(self._hooks)


trainer_zoo = {
    "pretrain": PretrainEncoderTrainer,
    "pretrain_encoder": PretrainEncoderTrainer,
}
