"""Trainers of the main path: the outer epoch loops around the steps.

The counterparts of `spcl_tpu/training/trainer.py`:

- `PretrainEncoderTrainer` (trainer.py:1110-1265; reference
  new_pretrain.py:18-110): loss = hook regularizers only, no eval,
  `last.ckpt` per `save_every` epochs; with `Trainer.grad_cache: N` the
  step is the chunked two-pass one of `training/gradcache.py`;
- `PretrainDecoderTrainer` (trainer.py:1338-1341): the same with both views
  sharing one geometry (`total_freedom` false), so that the dense points of
  a decoder hook align;
- `FineTuneTrainer` (trainer.py:1006-1031 with what it inherits from
  `Trainer`; reference new_trainer.py:59-76): labeled-only training of the
  whole UNet, per-scan 3D Dice on the val and test loaders after every
  epoch, `best.ckpt` at every improvement of the val DSC, `storage.csv`;
- `SemiTrainer` (`Trainer` itself, trainer.py:64-1003; reference
  new_trainer.py:17-56): the same loop around `build_semi_step`, over the
  labeled and the unlabeled streams, with the hooks' regularisers and, when
  a hook needs it, the EMA teacher (`models/ema.py`), whose alpha_max is the
  hooks' `alpha` (spcl_tpu's trainer leaves it at 0.999: ROADMAP C);
- `MixUpTrainer` (trainer.py:1034-1048): labeled-only with the MixUp hook;
- `AdversarialTrainer` (trainer.py:1051-1107; reference new_trainer.py
  AdversarialTrainer): the semi loop around `build_adversarial_step`, with
  the discriminator (`models/discriminator.py`) and its Adam (b1 0.5, b2
  0.999, lr 1e-4) made at `init()` and kept in the checkpoints.

All share `_TrainerBase`: `init()` moves the UNet and the hooks' projectors
to the device, warm-starts from `Arch.checkpoint`, freezes the stages outside
`set_trainable_stages` (no update, no weight decay), and builds the `Optim`
block's optimizer (`training/optim.py`) over the trainable parameters and the
projectors; each epoch sets the learning rate (warmup x multiplier -> cosine,
per epoch), draws the epoch's `num_batches` index vectors from the loader's
sampler, runs the steps, then drains the metrics once, failing fast on a
non-finite loss.

Data path (`device_data`, spcl_tpu trainer.py:76-83, true as
`config/base.yaml` sets it): `init()` uploads each loader's root dataset
once (`data/device_store.py`); an epoch uploads its [num_batches, B] matrix
of global indices (spcl_tpu `_index_matrix`, trainer.py:520-525) and step b
gathers row b on the device, so no step builds a host batch. Fine-tune Dice
groups by `root.scan_names` of the global indices (`_groups_and_valid`,
:581-588); eval runs per-scan index vectors, or with `Trainer.packed_eval:
N` fixed batches of N slices across scan boundaries (`_packed_eval_batches`,
:648-676): the per-scan Dice is the same, the logged eval loss becomes a
mean over chunks instead of scans. `device_data: false` builds host batches
and copies them through `data/loader.py::device_prefetch` (pinned buffers,
side stream, depth 3); `packed_eval` then changes nothing, as in spcl_tpu.
Throughput counts real slices (index >= 0).

Randomness inside the steps comes from one `torch.Generator` on the device,
seeded from the config's RandomSeed.

`mesh=N|"auto"` (`Trainer.mesh`, spcl_tpu/training/trainer.py:93-99) makes the
trainer one rank of an N-rank run (`parallel/mesh.py`; the entry points start
the ranks). Every rank iterates the same seed-deterministic samplers, so all
hold the same global batch, right-padded with `valid=0` entries to a rank
multiple (a pad entry holds slice 0 as filler, as in the JAX package, and
passes through the UNet and its BatchNorm statistics), and the steps compute
on the rank's rows. The replicas start from rank 0's weights and stay equal
because every rank applies the same summed gradient. Only rank 0 writes:
`storage.csv`, checkpoints, `.success`, log lines; a barrier ends
`start_training` so that no rank reads a checkpoint before it is written.
One rank is the plain single-process path.

`resume_from_path` (trainer.py:972-987; `trainer_checkpoint` in the entry
points) restores everything `last.ckpt` holds — the model, the optimizer
state, the projectors, the hooks' schedulers, the EMA teacher and its step
count, the epoch, the best score and the storage — and, beyond spcl_tpu,
the step generator's state and the samplers' numpy generators (and the
adversarial trainer's discriminator and its Adam state), so that a resumed
run continues the uninterrupted one to the bit.

Not ported yet: TensorBoard; `Trainer.dump_matrices`, `profile_dir` and
`defer_reads` are refused by `entry.common.build_trainer` when set, and so is
a mesh with the semi, mixup or adversarial trainer or a decoder hook, and
resume under a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import load_checkpoint, load_model_state_dict, save_checkpoint
from .gradcache import build_gradcache_pretrain_step
from .optim import Adam, build_optimizer
from .steps import (build_adversarial_step, build_eval_step, build_finetune_step,
                    build_pretrain_step, build_semi_step)
from ..data.augment import POLICY_ZOO, AugmentPolicy
from ..data.device_store import DeviceStore
from ..data.loader import HostLoader, device_prefetch
from ..hooks.base import TrainerHook, get_individual_hooks
from ..meters import (AverageValueMeter, MeterInterface, Storage, UniversalDice,
                      meter_display)
from ..models.discriminator import Discriminator
from ..models.ema import EMATeacher
from ..models.masking import set_trainable_stages
from ..models.unet import UNet
from ..parallel import mesh as mesh_lib
from ..schedulers.lr import warmup_cosine_epoch_schedule
from ..utils.utils import get_logger

logger = get_logger("trainer")


class _TrainerBase:
    """What every trainer shares: registration, policies, `init()`, the
    per-epoch learning rate, and checkpoint writing."""
    policy_kind = "label"
    train_meter_focus = "tra"

    def __init__(self, *, model: UNet, save_dir: str, max_epoch: int = 100,
                 num_batches: int = 100, config: Optional[Dict] = None, seed: int = 10,
                 crop: int = 224, data_name: str = "acdc", device="cuda", mesh=0,
                 device_data: bool = True):
        self._n_shards = self._join_mesh(mesh, device)
        self._device_data = bool(device_data)
        self._is_master = mesh_lib.on_master()
        self._device = mesh_lib.rank_device(device)
        self._model = model
        self._save_dir = str(save_dir)
        self._max_epoch = int(max_epoch)
        self._num_batches = int(num_batches)
        self._config = config or {}
        self._seed = int(seed)
        self._crop = int(crop)
        self._data_name = data_name
        self._hooks: List[TrainerHook] = []
        self._trainable_stages: Optional[List[str]] = None
        self._teacher: Optional[EMATeacher] = None
        self._cur_epoch = 0
        self._initialized = False
        self.last_epoch_stats: Dict = {}

    # ----------------------------------------------------------------- mesh
    @staticmethod
    def _join_mesh(spec, device) -> int:
        """Join the run's process group when `mesh` asks for ranks; returns
        the number of ranks. One rank (or `mesh` off) is the plain path."""
        want = mesh_lib.requested_ranks(spec, device)
        if want == 1:
            return 1
        world = mesh_lib.initialize_distributed(device=device)
        if world != want:
            raise RuntimeError(
                f"Trainer.mesh={spec!r} asks for {want} ranks but this process is part of "
                f"{world}: start the ranks through an entry point "
                "(spcl_torch.main_pretrain_encoder), parallel.mesh.spawn_local, or one "
                "process per rank with SPCL_COORDINATOR / SPCL_NUM_PROCESSES / "
                "SPCL_PROCESS_ID set")
        return world

    @property
    def n_shards(self) -> int:
        return self._n_shards

    # ----------------------------------------------------------------- data
    def _loaders(self) -> List[HostLoader]:
        raise NotImplementedError

    def _store(self, loader: HostLoader) -> Optional[DeviceStore]:
        """The store of the loader's root dataset on this rank's device
        (`device_data`), or None on the host path."""
        if not self._device_data:
            return None
        return DeviceStore.for_dataset(loader.dataset, self._device)

    def _index_rows(self, loader: HostLoader, n: int) -> np.ndarray:
        """The next `n` index vectors of the loader's sampler (indices into
        its dataset), right-padded with -1 (`valid=0`) to a rank multiple."""
        it = iter(loader.sampler)
        return np.stack([mesh_lib.pad_multiple(np.asarray(next(it)), self._n_shards)
                         for _ in range(n)])

    def _upload_rows(self, rows: Sequence[np.ndarray]) -> Sequence[torch.Tensor]:
        """Index vectors on the device, uploaded in one copy (pinned on a card)."""
        if not len(rows):
            return []
        flat = torch.from_numpy(np.ascontiguousarray(np.concatenate(rows), dtype=np.int64))
        if self._device.type == "cuda":
            flat = flat.pin_memory()
        return torch.split(flat.to(self._device, non_blocking=True), [len(r) for r in rows])

    def _step_inputs(self, loader: HostLoader, rows: Sequence[np.ndarray]):
        """What the steps take for these local index vectors: their global
        indices on the device (`device_data`), or host batches copied through
        `device_prefetch`."""
        ds = loader.dataset
        if self._device_data:
            return self._upload_rows([ds.to_global(r) for r in rows])
        return device_prefetch((ds.batch(r) for r in rows), self._device)

    def _log(self, msg: str, *args) -> None:
        if self._is_master:
            logger.info(msg, *args, stacklevel=2)

    def _finish(self) -> None:
        """End of `start_training`: the success marker, then a barrier, so
        that what rank 0 wrote is there for every rank that goes on."""
        if self._is_master:
            from .. import success
            success(self._save_dir)
        mesh_lib.host_barrier()

    # ----------------------------------------------------------------- registration
    def register_hooks(self, *hooks: TrainerHook) -> None:
        if self._initialized:
            raise RuntimeError("register_hooks must be called before init()")
        self._hooks.extend(get_individual_hooks(*hooks))

    def set_trainable_stages(self, stages: Sequence[str]) -> None:
        """`set_grad` (reference arch/unet.py:242-259): only these stages train."""
        self._trainable_stages = list(stages)

    def _zoo_policy(self, kind: str) -> AugmentPolicy:
        policy = POLICY_ZOO[self._data_name][kind]
        if policy.crop != self._crop:
            # keep resize targets self-similar under a crop override
            resize = policy.resize
            if resize == policy.crop:
                resize = self._crop
            elif resize == (policy.crop, policy.crop):
                resize = (self._crop, self._crop)
            policy = dataclasses.replace(policy, crop=self._crop, resize=resize)
        return policy

    @property
    def train_policy(self) -> AugmentPolicy:
        return self._zoo_policy(self.policy_kind)

    @property
    def val_policy(self) -> AugmentPolicy:
        return self._zoo_policy("val")

    # ----------------------------------------------------------------- init
    def init(self) -> None:
        if self._n_shards > 1 and self._model.small_c_layout == "pallas":
            # as spcl_tpu refuses it (training/trainer.py:245-253): the fused
            # stages compute single-device BatchNorm statistics
            raise ValueError("Arch.small_c_layout='pallas' is incompatible with "
                             "Trainer.mesh — use 'nhwc'")
        self._model.to(self._device)
        ckpt = (self._config.get("Arch") or {}).get("checkpoint")
        if ckpt:
            self._model.load_state_dict(load_model_state_dict(ckpt), strict=False)
            self._log("warm-started model weights from %s", ckpt)
        if self._trainable_stages is not None:
            set_trainable_stages(self._model, self._trainable_stages)
        for h in self._hooks:
            h.build(self._model, self._device)
        for loader in self._loaders():
            self._store(loader)  # one upload per root dataset, before the first epoch
        if self._n_shards > 1:
            # the replicas start from rank 0's weights whatever seeded them
            mesh_lib.broadcast_tensors(
                list(self._model.state_dict().values())
                + [t for h in self._hooks if h.projector is not None
                   for t in h.projector.state_dict().values()])

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
            weight_decay=float(optim_cfg.get("weight_decay", 0.0)),
            momentum=float(optim_cfg.get("momentum", 0.9)),
            nesterov=bool(optim_cfg.get("nesterov", False)))
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(self._seed)
        self._build_steps()
        self._initialized = True

    def _build_steps(self) -> None:
        raise NotImplementedError

    # ----------------------------------------------------------------- epochs
    def _hook_scalars(self) -> Dict[str, Dict[str, float]]:
        # _cur_epoch is 1-based; epoch e uses the scheduler value at e-1
        # (reference semi_seg/hooks/infonce.py:133-136), as spcl_tpu does
        return {h.name: h.epoch_scalars(self._cur_epoch - 1) for h in self._hooks}

    def _epoch_lr(self) -> float:
        return float(self._lr_schedule(max(self._cur_epoch - 1, 0) * self._num_batches))

    def _set_epoch_lr(self) -> float:
        lr = self._epoch_lr()
        for group in self._optimizer.param_groups:
            group["lr"] = lr
        return lr

    def _synchronize(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _save_now(self) -> bool:
        save_every = int((self._config.get("Trainer") or {}).get("save_every", 1))
        return (self._cur_epoch % max(save_every, 1) == 0
                or self._cur_epoch == self._max_epoch)

    def _hook_metric_arrays(self, pending: List[Dict]) -> Dict[str, Dict[str, np.ndarray]]:
        """{hook: {metric: [steps] numpy}} of an epoch's step outputs, one
        device -> host copy per metric."""
        if not pending or "hooks" not in pending[0]:
            return {}
        return {name: {k: torch.stack([torch.as_tensor(m["hooks"][name][k],
                                                       device=self._device)
                                       for m in pending]).cpu().numpy()
                       for k in pending[0]["hooks"][name]}
                for name in pending[0]["hooks"]}

    @staticmethod
    def _add_hook_meters(meters: MeterInterface, hooks: Dict[str, Dict[str, float]]) -> None:
        for name, hm in hooks.items():
            with meters.focus_on(name):
                for k, v in hm.items():
                    if k not in meters:  # hook meters register on first use
                        meters.register_meter(k, AverageValueMeter())
                    meters[k].add(v)

    # ----------------------------------------------------------------- io
    def _sampler_rngs(self) -> List:
        return [getattr(loader.sampler, "_rng", None) for loader in self._loaders()]

    def _checkpoint_state(self) -> Dict:
        state = {"_model": self._model.state_dict(),
                 "_optimizer": self._optimizer.state_dict(),
                 "cur_epoch": self._cur_epoch,
                 "_hooks": {h.name: h.projector.state_dict() for h in self._hooks
                            if h.projector is not None},
                 "_hook_states": {h.name: h.state_dict() for h in self._hooks},
                 "_generator": self._generator.get_state(),
                 "_samplers": [None if rng is None else rng.bit_generator.state
                               for rng in self._sampler_rngs()]}
        if self._teacher is not None:
            state["_teacher"] = self._teacher.state_dict()
        return state

    def save_to(self, save_name: str) -> None:
        if not self._is_master:
            return
        save_checkpoint(str(Path(self._save_dir) / save_name), self._checkpoint_state())

    def resume_from_path(self, path: str) -> None:
        """Continue the run that wrote checkpoint `path` (after `init()`)."""
        if not self._initialized:
            raise RuntimeError("call init() before resume_from_path")
        if self._n_shards > 1:
            raise NotImplementedError("resume under Trainer.mesh is not ported yet "
                                      "(ROADMAP A12 rest)")
        state = load_checkpoint(path)
        self._model.load_state_dict(state["_model"], strict=True)
        for h in self._hooks:
            if h.projector is not None:
                h.projector.load_state_dict(state["_hooks"][h.name], strict=True)
            h.load_state_dict(state["_hook_states"][h.name])
        if self._teacher is not None:
            self._teacher.load_state_dict(state["_teacher"])
        self._optimizer.load_state_dict(state["_optimizer"])
        self._generator.set_state(state["_generator"])
        for rng, saved in zip(self._sampler_rngs(), state["_samplers"]):
            if rng is not None:
                rng.bit_generator.state = saved
        self._cur_epoch = int(state["cur_epoch"])
        self._restore_extra(state)
        self._log("resumed from %s at epoch %d", path, self._cur_epoch)

    def _restore_extra(self, state: Dict) -> None:
        """What a subclass adds to `_checkpoint_state`."""

    @property
    def save_dir(self) -> str:
        return self._save_dir

    @property
    def model(self) -> UNet:
        return self._model

    @property
    def hooks(self) -> List[TrainerHook]:
        return list(self._hooks)

    @property
    def teacher(self) -> Optional[EMATeacher]:
        """The EMA teacher (semi trainer with a teacher hook), else None."""
        return self._teacher


class PretrainEncoderTrainer(_TrainerBase):
    """Contrastive encoder pretraining: loss = hook regularizers only, no
    eval, `last.ckpt` per `save_every` epochs. Each epoch reads gamma from
    the hooks' `epoch_scalars` and drains `reg_loss` plus each hook's
    `sp_weight` / `age_param` meters."""
    total_freedom = True  # independent geometry per view
    policy_kind = "pretrain"

    def __init__(self, *, contrastive_loader: HostLoader,
                 forward_until: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self._contrastive_loader = contrastive_loader
        self._forward_until = forward_until
        # one entry per step, host floats: {"epoch", "reg_loss", "hooks"}
        self.step_metrics: List[Dict] = []

    def _loaders(self) -> List[HostLoader]:
        return [self._contrastive_loader]

    def _build_steps(self) -> None:
        grad_cache = int((self._config.get("Trainer") or {}).get("grad_cache") or 0)
        kwargs = dict(policy=self.train_policy, total_freedom=self.total_freedom,
                      until=self._forward_until, store=self._store(self._contrastive_loader))
        if grad_cache:
            self._train_step = build_gradcache_pretrain_step(
                self._model, self._hooks, self._optimizer, num_chunks=grad_cache, **kwargs)
        else:
            self._train_step = build_pretrain_step(self._model, self._hooks, self._optimizer,
                                                   **kwargs)

    def _run_train_epoch(self) -> Dict:
        meters = MeterInterface(default_focus=self.train_meter_focus)
        with meters.focus_on(self.train_meter_focus):
            meters.register_meter("lr", AverageValueMeter())
            meters.register_meter("reg_loss", AverageValueMeter())
        scalars = self._hook_scalars()
        lr = self._set_epoch_lr()
        rows = self._index_rows(self._contrastive_loader, self._num_batches)
        # real views: the contrast sampler and the rank padding add -1 entries
        n_slices = 2 * int((rows >= 0).sum())
        inputs = self._step_inputs(self._contrastive_loader, rows)
        pending = []
        self._synchronize()
        t0 = time.perf_counter()
        for batch in inputs:
            pending.append(self._train_step(batch, self._generator, scalars))
        self._synchronize()
        elapsed = time.perf_counter() - t0
        # one device -> host copy per epoch: no per-step synchronisation
        reg = torch.stack([m["reg_loss"] for m in pending]).cpu().numpy()
        hook_vals = self._hook_metric_arrays(pending)
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
            self._add_hook_meters(meters, record["hooks"])
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
        for self._cur_epoch in range(start, self._max_epoch + 1):
            train_stats = self._run_train_epoch()
            self.last_epoch_stats = train_stats
            # the hooks' schedulers step before the checkpoint, so that it
            # holds the state a resumed run continues from
            for h in self._hooks:
                h.on_epoch_end()
            if self._save_now():
                self.save_to("last.ckpt")
            self._log("pretrain epoch %03d | %s", self._cur_epoch,
                      meter_display(train_stats))
        self._finish()
        return 0.0


class PretrainDecoderTrainer(PretrainEncoderTrainer):
    """Decoder pretraining: the two views share one geometry (the reference
    asserts total_freedom=False, new_pretrain.py:104-110) so that the dense
    positions of a decoder hook align. `build_trainer` trains Conv5 up to the
    hooks' deepest stage; the encoder below Conv5 takes no update, and its
    BatchNorm still updates its running statistics, as spcl_tpu's does."""
    total_freedom = False


class FineTuneTrainer(_TrainerBase):
    """Labeled-only training of the whole UNet (reference new_trainer.py:59-76,
    no hooks) with per-scan Dice on the val and test loaders after every
    epoch; `start_training` returns the best val DSC."""
    activate_hooks = False

    def __init__(self, *, labeled_loader: HostLoader, val_loader: HostLoader,
                 test_loader: Optional[HostLoader] = None, **kwargs):
        super().__init__(**kwargs)
        self._labeled_loader = labeled_loader
        self._val_loader = val_loader
        self._test_loader = test_loader
        self._best_score = -np.inf
        self._storage = Storage(save_dir=self._save_dir if self._is_master else None)
        # one entry per train step, host floats: {"epoch", "sup_loss"} (+ the
        # semi trainer's "reg_loss", and "hooks" for trainers with hooks)
        self.step_metrics: List[Dict] = []

    def register_hooks(self, *hooks: TrainerHook) -> None:
        if hooks and not self.activate_hooks:
            raise NotImplementedError("fine-tuning runs without hooks "
                                      "(reference FineTuneTrainer.activate_hooks)")
        super().register_hooks(*hooks)

    def _eval_out_size(self) -> int:
        """The eval canvas. Shortest-side val policies (Resize(int)) can
        produce frames longer than `crop` on one side of non-square slices;
        size the canvas from the datasets' stored extents (square data ->
        crop)."""
        pol = self.val_policy
        if not isinstance(pol.resize, int):
            return self._crop
        out = self._crop
        for loader in (self._val_loader, self._test_loader):
            if loader is None:
                continue
            sizes = np.asarray(loader.dataset.sizes, np.float64)
            out = max(out, int(np.max(np.floor(pol.resize * sizes.max(axis=1)
                                               / sizes.min(axis=1)))))
        # the decoder upsamples by exact x2 per stage: keep every pooled dim
        # even (4 pool levels -> multiple of 16); extra padding is masked
        return ((out + 15) // 16) * 16

    def _loaders(self) -> List[HostLoader]:
        return [loader for loader in (self._labeled_loader, self._val_loader,
                                      self._test_loader) if loader is not None]

    def _build_steps(self) -> None:
        self._train_step = build_finetune_step(
            self._model, self._optimizer, num_classes=self._model.num_classes,
            policy=self.train_policy, store=self._store(self._labeled_loader),
            hooks=self._hooks)
        self._eval_steps = {}

    def _eval_step_for(self, loader: HostLoader):
        """The eval step over the loader's store (one per root dataset)."""
        store = self._store(loader)
        if id(store) not in self._eval_steps:
            self._eval_steps[id(store)] = build_eval_step(
                self._model, num_classes=self._model.num_classes, crop=self._crop,
                val_policy=self.val_policy, out_size=self._eval_out_size(), store=store)
        return self._eval_steps[id(store)]

    # ----------------------------------------------------------------- epochs
    def _epoch_inputs(self):
        """(the labeled batches' global index rows, an iterable of the steps'
        batch arguments, the real slices the epoch trains on)."""
        loader = self._labeled_loader
        rows = self._index_rows(loader, self._num_batches)
        return (loader.dataset.to_global(rows),
                ((b,) for b in self._step_inputs(loader, rows)), int((rows >= 0).sum()))

    def _call_step(self, batches, scalars: Dict) -> Dict:
        if self._hooks:
            return self._train_step(*batches, self._generator, hook_scalars=scalars)
        return self._train_step(*batches, self._generator)

    def _loss_keys(self) -> Tuple[str, ...]:
        return ("sup_loss",)

    def _loss_focus(self, key: str) -> str:
        """The meter group a loss key is logged under."""
        return self.train_meter_focus

    def _run_train_epoch(self) -> Dict:
        C = self._model.num_classes
        keys = self._loss_keys()
        meters = MeterInterface(default_focus=self.train_meter_focus)
        with meters.focus_on(self.train_meter_focus):
            meters.register_meter("lr", AverageValueMeter())
        for k in keys:
            with meters.focus_on(self._loss_focus(k)):
                meters.register_meter(k, AverageValueMeter())
        with meters.focus_on(self.train_meter_focus):
            meters.register_meter("sup_dice", UniversalDice(C, report_axises=list(range(1, C))))
        scalars = self._hook_scalars()
        lr = self._set_epoch_lr()
        # Dice groups by scan name through the root (a subset's scan_idx is
        # its own numbering, the store's the root's)
        names = self._labeled_loader.dataset.root.scan_names
        global_rows, inputs, n_slices = self._epoch_inputs()
        pending = []
        self._synchronize()
        t0 = time.perf_counter()
        for batches in inputs:
            pending.append(self._call_step(batches, scalars))
        self._synchronize()
        elapsed = time.perf_counter() - t0
        # one device -> host copy per metric per epoch: no per-step synchronisation
        stacked = {k: torch.stack([m[k] for m in pending]).cpu().numpy()
                   for k in keys + ("inter", "union")}
        hook_vals = self._hook_metric_arrays(pending)
        for b, gidx in enumerate(global_rows):
            record = {"epoch": self._cur_epoch}
            for k in keys:
                record[k] = float(stacked[k][b])
                # fail fast on NaN like the reference criterion (contrast_loss3.py:108)
                if not np.isfinite(record[k]):
                    raise RuntimeError(f"non-finite {k} at batch {b}: {record[k]}")
            if hook_vals:
                record["hooks"] = {n: {k: float(v[b]) for k, v in hv.items()}
                                   for n, hv in hook_vals.items()}
                self._add_hook_meters(meters, record["hooks"])
            self.step_metrics.append(record)
            for k in keys:
                with meters.focus_on(self._loss_focus(k)):
                    meters[k].add(record[k])
            with meters.focus_on(self.train_meter_focus):
                keep = gidx >= 0
                meters["sup_dice"].add(stacked["inter"][b][keep], stacked["union"][b][keep],
                                       group_name=[names[i] for i in gidx[keep]])
        with meters.focus_on(self.train_meter_focus):
            meters["lr"].add(lr)
        stats = meters.statistics()
        stats.setdefault(self.train_meter_focus, {})["throughput"] = {
            "slices_per_sec": n_slices / max(elapsed, 1e-9),
            "steps_per_sec": len(pending) / max(elapsed, 1e-9)}
        return stats

    def _run_eval_epoch(self, loader: HostLoader) -> Tuple[Dict, float]:
        C = self._model.num_classes
        meters = MeterInterface(default_focus="eval")
        meters.register_meter("loss", AverageValueMeter())
        dice = meters.register_meter("dice", UniversalDice(C, report_axises=list(range(1, C))))
        packed = int((self._config.get("Trainer") or {}).get("packed_eval") or 0)
        if self._device_data and packed > 0:
            rows, groups = self._packed_eval_rows(loader, packed)
            inputs = self._upload_rows(rows)
        else:
            sampler = loader.sampler
            rows = [mesh_lib.pad_multiple(np.asarray(idx), self._n_shards) for idx in sampler]
            groups = [sampler.scan_of_batch(i) for i in range(len(rows))]
            inputs = self._step_inputs(loader, rows)
        step = self._eval_step_for(loader)
        pending = [step(batch) for batch in inputs]
        if pending:
            stacked = {k: torch.stack([o[k] for o in pending]).cpu().numpy()
                       for k in ("loss", "inter", "union")}
        for b, (row, group) in enumerate(zip(rows, groups)):
            meters["loss"].add(float(stacked["loss"][b]))
            keep = np.asarray(row) >= 0
            if isinstance(group, list):  # packed_eval: a scan name per slice
                group = [g for g, k in zip(group, keep) if k]
            dice.add(stacked["inter"][b][keep], stacked["union"][b][keep], group_name=group)
        stats = meters.statistics("eval")
        return stats, float(stats["dice"]["DSC_mean"])

    def _packed_eval_rows(self, loader: HostLoader, packed: int):
        """(global index rows, per-slice scan names) of `Trainer.packed_eval`
        (spcl_tpu `_packed_eval_batches`, trainer.py:648-676): every scan's
        slices in scan order, cut into batches of `packed` (at least one per
        rank), -1 padding named ""."""
        ds = loader.dataset
        flats, names = [], []
        for scan, idx in sorted(ds.scan_to_indices().items()):
            flats.append(ds.to_global(idx))
            names.extend([scan] * len(idx))
        flat = np.concatenate(flats) if flats else np.zeros((0,), np.int64)
        size = max(int(packed), self._n_shards)
        rows, groups = [], []
        for start in range(0, len(flat), size):
            chunk = flat[start:start + size]
            chunk = np.concatenate([chunk, np.full(size - len(chunk), -1, np.int64)])
            rows.append(mesh_lib.pad_multiple(chunk, self._n_shards))
            chunk_names = names[start:start + size]
            groups.append(chunk_names + [""] * (len(rows[-1]) - len(chunk_names)))
        return rows, groups

    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        for self._cur_epoch in range(start, self._max_epoch + 1):
            train_stats = self._run_train_epoch()
            self.last_epoch_stats = train_stats
            val_stats, cur_score = self._run_eval_epoch(self._val_loader)
            test_stats, _ = (self._run_eval_epoch(self._test_loader)
                             if self._test_loader is not None else ({}, 0.0))
            # the epoch's row and the hooks' scheduler steps go in before the
            # checkpoints, so that they hold the state a resumed run continues
            # from (spcl_tpu writes them after, and its checkpoints lag by one)
            self._storage.put_epoch(self._cur_epoch, {**train_stats, "val": val_stats,
                                                      "test": test_stats})
            self._storage.flush()
            for h in self._hooks:
                h.on_epoch_end()
            is_best = cur_score > self._best_score
            if is_best:
                self._best_score = cur_score
                self.save_to("best.ckpt")
            if self._save_now():
                self.save_to("last.ckpt")
            self._log("epoch %03d | val DSC %.4f (best %.4f) | %s", self._cur_epoch,
                      cur_score, self._best_score, meter_display(train_stats))
        self._finish()
        return float(self._best_score)

    def _checkpoint_state(self) -> Dict:
        state = super()._checkpoint_state()
        state["best_score"] = float(self._best_score)
        state["storage"] = self._storage.state_dict()
        return state

    def _restore_extra(self, state: Dict) -> None:
        self._best_score = float(state["best_score"])
        self._storage.load_state_dict(state["storage"])

    @property
    def best_score(self) -> float:
        return float(self._best_score)


class MixUpTrainer(FineTuneTrainer):
    """Labeled-only training with the MixUp hook (reference new_trainer.py
    MixUpTrainer + MixUpEpocher, new_comparable.py:18-86): two labeled views
    a step, the hooks' losses added to the cross-entropy."""
    activate_hooks = True


class SemiTrainer(FineTuneTrainer):
    """Semi-supervised training (reference new_trainer.py:17-56): each step
    takes a labeled batch and an unlabeled batch (`build_semi_step`); the
    hooks regularise the unlabeled pair. An EMA teacher is made at `init()`
    when a hook needs it. Throughput counts the labeled slices and the two
    views of each unlabeled one."""
    activate_hooks = True

    def __init__(self, *, unlabeled_loader: HostLoader, two_stage: bool = False,
                 disable_bn: bool = False, **kwargs):
        super().__init__(**kwargs)
        self._unlabeled_loader = unlabeled_loader
        self._two_stage = bool(two_stage)
        self._disable_bn = bool(disable_bn)

    def _loaders(self) -> List[HostLoader]:
        return super()._loaders() + [self._unlabeled_loader]

    def _build_steps(self) -> None:
        alphas = sorted({h.alpha for h in self._hooks if h.needs_teacher})
        if len(alphas) > 1:
            raise ValueError(f"the teacher hooks ask for different EMA alphas: {alphas}")
        self._teacher = EMATeacher(self._model, alphas[0]) if alphas else None
        self._train_step = build_semi_step(
            self._model, self._hooks, self._optimizer, num_classes=self._model.num_classes,
            policy=self.train_policy, two_stage=self._two_stage, disable_bn=self._disable_bn,
            teacher=self._teacher, store=self._store(self._labeled_loader))
        self._eval_steps = {}

    def _epoch_inputs(self):
        lab, unl = self._labeled_loader, self._unlabeled_loader
        rows_l = self._index_rows(lab, self._num_batches)
        rows_u = self._index_rows(unl, self._num_batches)
        n_slices = int((rows_l >= 0).sum()) + 2 * int((rows_u >= 0).sum())
        inputs = zip(self._step_inputs(lab, rows_l), self._step_inputs(unl, rows_u))
        return lab.dataset.to_global(rows_l), inputs, n_slices

    def _call_step(self, batches, scalars: Dict) -> Dict:
        return self._train_step(*batches, self._generator, scalars)

    def _loss_keys(self) -> Tuple[str, ...]:
        return ("sup_loss", "reg_loss")


class AdversarialTrainer(SemiTrainer):
    """The adversarial semi-supervised baseline (reference new_trainer.py
    AdversarialTrainer + AdversarialEpocher): each step takes a labeled and
    an unlabeled batch (`build_adversarial_step`). The discriminator is made
    at `init()` from the run's seed, its input the class softmax (and the
    image's channels with `dis_consider_image`); its Adam runs at `discr_lr`
    with b1 0.5, b2 0.999. Meters `adv_reg/gen_loss` and `adv_reg/dis_loss`.
    Hooks are not activated (spcl_tpu's step reads none)."""
    activate_hooks = False

    def __init__(self, *, reg_weight: float = 0.01, dis_consider_image: bool = False,
                 discr_lr: float = 1e-4, **kwargs):
        super().__init__(**kwargs)
        self._reg_weight = float(reg_weight)
        self._dis_consider_image = bool(dis_consider_image)
        self._discr_lr = float(discr_lr)

    def _build_steps(self) -> None:
        in_ch = self._model.num_classes + (self._model.input_dim if self._dis_consider_image
                                           else 0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self._seed)
            self._discriminator = Discriminator(in_ch).to(self._device)
        self._discr_optimizer = Adam(self._discriminator.parameters(), lr=self._discr_lr,
                                     betas=(0.5, 0.999))
        self._train_step = build_adversarial_step(
            self._model, self._discriminator, self._optimizer, self._discr_optimizer,
            num_classes=self._model.num_classes, policy=self.train_policy,
            reg_weight=self._reg_weight, dis_consider_image=self._dis_consider_image,
            store=self._store(self._labeled_loader))
        self._eval_steps = {}

    def _call_step(self, batches, scalars: Dict) -> Dict:
        return self._train_step(*batches, self._generator)

    def _loss_keys(self) -> Tuple[str, ...]:
        return ("sup_loss", "gen_loss", "dis_loss")

    def _loss_focus(self, key: str) -> str:
        return "adv_reg" if key in ("gen_loss", "dis_loss") else self.train_meter_focus

    def _checkpoint_state(self) -> Dict:
        state = super()._checkpoint_state()
        state["_discriminator"] = self._discriminator.state_dict()
        state["_discr_optimizer"] = self._discr_optimizer.state_dict()
        return state

    def _restore_extra(self, state: Dict) -> None:
        super()._restore_extra(state)
        self._discriminator.load_state_dict(state["_discriminator"], strict=True)
        self._discr_optimizer.load_state_dict(state["_discr_optimizer"])

    @property
    def discriminator(self) -> Discriminator:
        return self._discriminator


trainer_zoo = {
    "semi": SemiTrainer,
    "mixup": MixUpTrainer,
    "adv": AdversarialTrainer,
    "ft": FineTuneTrainer,
    "finetune": FineTuneTrainer,
    "pretrain": PretrainEncoderTrainer,
    "pretrain_encoder": PretrainEncoderTrainer,
    "pretrain_decoder": PretrainDecoderTrainer,
}
