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

All share `_TrainerBase` (exported as `Trainer`, spcl_tpu's name): `init()` moves the UNet and the hooks' projectors
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
One rank is the plain single-process path. Every trainer runs so, with
spcl_tpu's global-batch semantics (`training/steps.py`): the semi trainer
with any hooks and its EMA teacher, the mixup and adversarial trainers (the
discriminator starts from rank 0's weights too) and both pretrain trainers,
with `resume_from_path` and `defer_reads`. `small_c_layout: pallas` and
`packed` are refused under a mesh, as spcl_tpu refuses them.

`resume_from_path` (trainer.py:972-987; `trainer_checkpoint` in the entry
points) restores everything `last.ckpt` holds — the model, the optimizer
state, the projectors, the hooks' schedulers, the EMA teacher and its step
count, the epoch, the best score and the storage — and, beyond spcl_tpu,
the step generator's state and the samplers' numpy generators (and the
adversarial trainer's discriminator and its Adam state), so that a resumed
run continues the uninterrupted one to the bit. Under a mesh rank 0 has
written the file: every rank waits at a barrier, then loads it.

Every trainer writes its run's `config.yaml` (with the git hash) and its
epochs' scalars to TensorBoard (`writer.py`; spcl_tpu trainer.py:125-137,
:935-944) on rank 0. `Trainer.profile_dir` traces epoch start + 1 under
torch.profiler, writes the chrome trace there and logs the device ms per step
(`utils/profiling.py`; spcl_tpu trainer.py:897-911). The trace holds the
program's spans, on the clock of the kernels they launch: each step's
`spcl.step` and its phases (`training/steps.py`, `training/gradcache.py`),
each UNet stage's `spcl.unet.<stage>` (`models/unet.py`, the student's and
the teacher's forward; read by name in such a trace past Conv2), and the
epoch's `spcl.epoch.schedule` (`_hook_scalars`, `_set_epoch_lr`, the hooks'
`on_epoch_end`), `spcl.epoch.rows` (`_index_rows`), `spcl.epoch.upload`
(`_step_inputs`), `spcl.epoch.drain` (`_stack_metrics`, `deferred.drain`)
and `spcl.epoch.stats` (`_epoch_stats`). `Trainer.dump_matrices`
(pretrain trainers, `device_data` true) runs `build_matrix_probe` on batch 0
of each epoch and writes its matrices as images (spcl_tpu trainer.py:
1151-1240).

`Trainer.defer_reads` (spcl_tpu trainer.py:755-882; `device_data` required,
the adversarial trainer runs eagerly as spcl_tpu's does) runs the whole
training without a device -> host read: the steps' metrics and the eval
statistics stay on the card, the val score is computed there
(`deferred.device_val_score`), and the best epoch's checkpoint state is kept
by a select on the card (`deferred.DeviceBest`). One drain at the end
rebuilds every epoch's storage row, meters and TensorBoard scalars and
writes `best.ckpt` and `last.ckpt` with the contents the eager loop writes
(the best epoch's optimizer state and metadata included, where spcl_tpu
keeps the final optimizer state). `Trainer.flush_every: N` drains and writes
the checkpoints every N epochs.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import deferred
from .checkpoint import load_checkpoint, load_model_state_dict, save_checkpoint
from .gradcache import build_gradcache_pretrain_step
from .optim import Adam, build_optimizer
from .steps import (build_adversarial_step, build_eval_step, build_finetune_step,
                    build_matrix_probe, build_pretrain_step, build_semi_step)
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
from ..utils import profiling
from ..utils.profiling import span
from ..utils.utils import get_logger, gethash, yaml_write
from ..writer import NullWriter, SummaryWriter

logger = get_logger("trainer")


class _TrainerBase:
    """What every trainer shares: registration, policies, `init()`, the
    per-epoch learning rate, and checkpoint writing."""
    policy_kind = "label"
    train_meter_focus = "tra"

    def __init__(self, *, model: UNet, save_dir: str, max_epoch: int = 100,
                 num_batches: int = 100, config: Optional[Dict] = None, seed: int = 10,
                 crop: int = 224, data_name: str = "acdc", device="cuda", mesh=0,
                 device_data: bool = True, defer_reads: bool = False):
        self._n_shards = self._join_mesh(mesh, device)
        self._device_data = bool(device_data)
        self._defer_reads = bool(defer_reads)
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
        # device ms per step of the epoch traced under `Trainer.profile_dir`
        self.profile_ms: Optional[float] = None
        self._writer = SummaryWriter(self._save_dir) if self._is_master else NullWriter()
        if self._config and self._is_master:
            # the run's config and git hash beside its results (reference
            # trainer/_io.py:54-60, spcl_tpu trainer.py:132-137)
            yaml_write({**self._config, "githash": gethash()}, self._save_dir, "config.yaml")

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
                f"{world}: start the ranks through an entry point (spcl_torch.main, "
                "main_mixup, main_adv, main_pretrain_encoder, main_pretrain_decoder), "
                "parallel.mesh.spawn_local, or one "
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
        with span("spcl.epoch.rows"):
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
        with span("spcl.epoch.upload"):
            ds = loader.dataset
            if self._device_data:
                return self._upload_rows([ds.to_global(r) for r in rows])
            return device_prefetch((ds.batch(r) for r in rows), self._device)

    def _log(self, msg: str, *args) -> None:
        if self._is_master:
            logger.info(msg, *args, stacklevel=2)

    def _trainer_cfg(self) -> Dict:
        return self._config.get("Trainer") or {}

    def _check_deferred(self) -> None:
        if not self._device_data:
            raise ValueError("Trainer.defer_reads requires Trainer.device_data "
                             "(the steps gather their batches on the device)")

    def _dispatch_maybe_profiled(self, start: int) -> Dict:
        """`_dispatch_train_epoch`, traced under torch.profiler when this is
        epoch start + 1 and `Trainer.profile_dir` is set (rank 0); the device
        ms per step of the trace goes to `profile_ms` and the log."""
        profile_dir = self._trainer_cfg().get("profile_dir")
        if not (profile_dir and self._cur_epoch == start + 1 and self._is_master):
            return self._dispatch_train_epoch()
        out = {}
        profiling.trace(lambda: out.update(record=self._dispatch_train_epoch()),
                        str(profile_dir))
        self.profile_ms = profiling.device_ms_per_step(str(profile_dir), calls=self._num_batches)
        if self.profile_ms is None:
            self._log("profiled epoch %d into %s: the trace holds no device time",
                      self._cur_epoch, profile_dir)
        else:
            self._log("profiled epoch %d into %s: %.3f ms/step device time", self._cur_epoch,
                      profile_dir, self.profile_ms)
        return out["record"]

    @staticmethod
    def _stack_metrics(pending: List[Dict]) -> Dict:
        """The steps' metric dicts as one tree of [steps, ...] arrays: device
        tensors stacked on the device, hook metrics that are host floats (a
        schedule's gamma) as float32 numpy, neither read nor uploaded."""
        def stack(values):
            if torch.is_tensor(values[0]):
                return torch.stack(values)
            return np.asarray(values, dtype=np.float32)

        with span("spcl.epoch.drain"):
            out = {}
            for k, v in pending[0].items():
                if k == "hooks":
                    out[k] = {name: {m: stack([p[k][name][m] for p in pending]) for m in hm}
                              for name, hm in v.items()}
                else:
                    out[k] = stack([p[k] for p in pending])
            return out

    def _finish(self) -> None:
        """End of `start_training`: the TensorBoard events flushed, the
        success marker, then a barrier, so that what rank 0 wrote is there for
        every rank that goes on."""
        self._writer.flush()
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
        # only the UNet has small-channel layouts
        layout = getattr(self._model, "small_c_layout", None)
        if self._n_shards > 1 and layout in ("pallas", "packed"):
            # as spcl_tpu refuses both (training/trainer.py:245-253): the fused
            # stages compute single-device BatchNorm statistics
            raise ValueError(f"Arch.small_c_layout={layout!r} is "
                             "incompatible with Trainer.mesh — use 'nhwc'")
        self._model.to(self._device)
        ckpt = (self._config.get("Arch") or {}).get("checkpoint")
        if ckpt:
            state = load_model_state_dict(ckpt)
            own = self._model.state_dict()
            if state and not any(k in own for k in state):
                raise ValueError(f"Arch.checkpoint {ckpt} holds no weight of this model "
                                 f"({type(self._model).__name__}): a checkpoint of another "
                                 "Arch.name?")
            self._model.load_state_dict(state, strict=False)
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
        with span("spcl.epoch.schedule"):
            # _cur_epoch is 1-based; epoch e uses the scheduler value at e-1
            # (reference semi_seg/hooks/infonce.py:133-136), as spcl_tpu does
            return {h.name: h.epoch_scalars(self._cur_epoch - 1) for h in self._hooks}

    def _epoch_lr(self) -> float:
        return float(self._lr_schedule(max(self._cur_epoch - 1, 0) * self._num_batches))

    def _set_epoch_lr(self) -> float:
        with span("spcl.epoch.schedule"):
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
        mesh_lib.host_barrier()  # rank 0 wrote the file; every rank reads it
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


Trainer = _TrainerBase  # spcl_tpu's name of the base class


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
        # `Trainer.dump_matrices`: the last epoch's {hook: {matrix: numpy}}
        self.last_matrices: Dict = {}

    def _loaders(self) -> List[HostLoader]:
        return [self._contrastive_loader]

    def _build_steps(self) -> None:
        grad_cache = int(self._trainer_cfg().get("grad_cache") or 0)
        kwargs = dict(policy=self.train_policy, total_freedom=self.total_freedom,
                      until=self._forward_until, store=self._store(self._contrastive_loader))
        if grad_cache:
            self._train_step = build_gradcache_pretrain_step(
                self._model, self._hooks, self._optimizer, num_chunks=grad_cache, **kwargs)
        else:
            self._train_step = build_pretrain_step(self._model, self._hooks, self._optimizer,
                                                   **kwargs)
        self._matrix_probe = None
        if self._trainer_cfg().get("dump_matrices"):
            if grad_cache:
                # spcl_tpu trainer.py:1152-1158: the probe's whole-batch [2N, 2N]
                # matrices bring back the memory wall grad_cache removes
                raise ValueError("Trainer.dump_matrices is incompatible with "
                                 "Trainer.grad_cache — disable one")
            if self._device_data:  # as spcl_tpu: the probe reads batch 0 of the store
                self._matrix_probe = build_matrix_probe(self._model, self._hooks, **kwargs)

    def _dispatch_train_epoch(self) -> Dict:
        """The epoch's steps, without a device -> host read: {"epoch", "lr",
        "n_slices", "elapsed", "metrics": [steps] device tensors, "matrices":
        the probe's, or None}."""
        scalars = self._hook_scalars()
        lr = self._set_epoch_lr()
        rows = self._index_rows(self._contrastive_loader, self._num_batches)
        # real views: the contrast sampler and the rank padding add -1 entries
        n_slices = 2 * int((rows >= 0).sum())
        inputs = self._step_inputs(self._contrastive_loader, rows)
        matrices = None
        if self._matrix_probe is not None and len(inputs):
            # batch 0's draws from a copy of the generator: the step's own
            # draws stay as they are without the probe
            probe_gen = torch.Generator(device=self._device)
            probe_gen.set_state(self._generator.get_state())
            matrices = self._matrix_probe(inputs[0], probe_gen, scalars)
        pending = []
        self._synchronize()  # a wait, not a read: the epoch's own time
        t0 = time.perf_counter()
        for batch in inputs:
            pending.append(self._train_step(batch, self._generator, scalars))
        self._synchronize()
        return {"epoch": self._cur_epoch, "lr": lr, "n_slices": n_slices,
                "elapsed": time.perf_counter() - t0, "steps": len(pending),
                "metrics": self._stack_metrics(pending), "matrices": matrices}

    def _epoch_stats(self, record: Dict, host: Dict) -> Dict:
        """Meters, `step_metrics` and TensorBoard of one epoch from its
        record and its drained metrics; fails on a non-finite loss."""
        with span("spcl.epoch.stats"):
            meters = MeterInterface(default_focus=self.train_meter_focus)
            with meters.focus_on(self.train_meter_focus):
                meters.register_meter("lr", AverageValueMeter())
                meters.register_meter("reg_loss", AverageValueMeter())
            reg = host["metrics"]["reg_loss"]
            hook_vals = host["metrics"].get("hooks", {})
            for b in range(record["steps"]):
                # fail fast on NaN like the reference criterion (contrast_loss3.py:108)
                if not np.isfinite(reg[b]):
                    raise RuntimeError(f"non-finite pretrain reg_loss at batch {b}: {reg[b]}")
                step = {"epoch": record["epoch"], "reg_loss": float(reg[b]),
                        "hooks": {n: {k: float(v[b]) for k, v in hv.items()}
                                  for n, hv in hook_vals.items()}}
                self.step_metrics.append(step)
                with meters.focus_on(self.train_meter_focus):
                    meters["reg_loss"].add(step["reg_loss"])
                self._add_hook_meters(meters, step["hooks"])
            with meters.focus_on(self.train_meter_focus):
                meters["lr"].add(record["lr"])
            stats = meters.statistics()
            elapsed = max(record["elapsed"], 1e-9)
            stats.setdefault(self.train_meter_focus, {})["throughput"] = {
                "slices_per_sec": record["n_slices"] / elapsed,
                "steps_per_sec": record["steps"] / elapsed}
            self._writer.add_scalars_from_meter_interface(record["epoch"], **stats)
            if host.get("matrices") is not None:
                self.last_matrices = host["matrices"]
                for hname, mats in host["matrices"].items():
                    for mname, m in mats.items():
                        self._writer.add_matrix_image(f"{hname}/{mname}", m, record["epoch"])
            return stats

    def _run_train_epoch(self) -> Dict:
        record = self._dispatch_train_epoch()
        # one device -> host copy per metric per epoch: no per-step synchronisation
        return self._epoch_stats(record, deferred.drain([record])[0])

    def _end_epoch(self) -> None:
        """The hooks' schedulers step before any checkpoint of the epoch, so
        that it holds the state a resumed run continues from."""
        for h in self._hooks:
            h.on_epoch_end()

    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        if self._defer_reads:
            return self._start_training_deferred()
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        for self._cur_epoch in range(start, self._max_epoch + 1):
            record = self._dispatch_maybe_profiled(start)
            train_stats = self._epoch_stats(record, deferred.drain([record])[0])
            self.last_epoch_stats = train_stats
            self._end_epoch()
            if self._save_now():
                self.save_to("last.ckpt")
            self._log("pretrain epoch %03d | %s", self._cur_epoch,
                      meter_display(train_stats))
        self._finish()
        return 0.0

    def _drain_records(self, records: List[Dict]) -> None:
        """The deferred epochs' meters and log lines, from one drain."""
        for record, host in zip(records, deferred.drain(
                [{"metrics": r["metrics"], "matrices": r["matrices"]} for r in records])):
            self.last_epoch_stats = self._epoch_stats(record, host)
            self._log("pretrain epoch %03d | %s", record["epoch"],
                      meter_display(self.last_epoch_stats))
        records.clear()

    def _start_training_deferred(self) -> float:
        """`Trainer.defer_reads` (spcl_tpu `_start_pretrain_deferred`,
        trainer.py:1267-1325): no read until the end (or a flush), then one
        drain of every epoch and `last.ckpt`."""
        self._check_deferred()
        flush_every = int(self._trainer_cfg().get("flush_every") or 0)
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        records: List[Dict] = []
        for self._cur_epoch in range(start, self._max_epoch + 1):
            records.append(self._dispatch_maybe_profiled(start))
            self._end_epoch()
            if flush_every and self._cur_epoch % flush_every == 0 \
                    and self._cur_epoch < self._max_epoch:
                self._drain_records(records)
                self.save_to("last.ckpt")
        self._drain_records(records)
        self.save_to("last.ckpt")
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

    def _dispatch_train_epoch(self) -> Dict:
        """The epoch's steps, without a device -> host read: {"epoch", "lr",
        "n_slices", "elapsed", "rows": the batches' global index rows,
        "metrics": [steps, ...] device tensors}."""
        scalars = self._hook_scalars()
        lr = self._set_epoch_lr()
        global_rows, inputs, n_slices = self._epoch_inputs()
        pending = []
        self._synchronize()  # a wait, not a read: the epoch's own time
        t0 = time.perf_counter()
        for batches in inputs:
            pending.append(self._call_step(batches, scalars))
        self._synchronize()
        return {"epoch": self._cur_epoch, "lr": lr, "n_slices": n_slices,
                "elapsed": time.perf_counter() - t0, "steps": len(pending),
                "rows": global_rows, "metrics": self._stack_metrics(pending)}

    def _epoch_stats(self, record: Dict, host: Dict) -> Dict:
        """Meters and `step_metrics` of one train epoch from its record and
        its drained metrics; fails on a non-finite loss."""
        with span("spcl.epoch.stats"):
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
            # Dice groups by scan name through the root (a subset's scan_idx is
            # its own numbering, the store's the root's)
            names = self._labeled_loader.dataset.root.scan_names
            stacked = host["metrics"]
            hook_vals = stacked.get("hooks", {})
            for b, gidx in enumerate(record["rows"]):
                step = {"epoch": record["epoch"]}
                for k in keys:
                    step[k] = float(stacked[k][b])
                    # fail fast on NaN like the reference criterion (contrast_loss3.py:108)
                    if not np.isfinite(step[k]):
                        raise RuntimeError(f"non-finite {k} at batch {b}: {step[k]}")
                if hook_vals:
                    step["hooks"] = {n: {k: float(v[b]) for k, v in hv.items()}
                                     for n, hv in hook_vals.items()}
                    self._add_hook_meters(meters, step["hooks"])
                self.step_metrics.append(step)
                for k in keys:
                    with meters.focus_on(self._loss_focus(k)):
                        meters[k].add(step[k])
                with meters.focus_on(self.train_meter_focus):
                    keep = gidx >= 0
                    meters["sup_dice"].add(stacked["inter"][b][keep], stacked["union"][b][keep],
                                           group_name=[names[i] for i in gidx[keep]])
            with meters.focus_on(self.train_meter_focus):
                meters["lr"].add(record["lr"])
            stats = meters.statistics()
            elapsed = max(record["elapsed"], 1e-9)
            stats.setdefault(self.train_meter_focus, {})["throughput"] = {
                "slices_per_sec": record["n_slices"] / elapsed,
                "steps_per_sec": record["steps"] / elapsed}
            return stats

    def _run_train_epoch(self) -> Dict:
        record = self._dispatch_train_epoch()
        # one device -> host copy per metric per epoch: no per-step synchronisation
        return self._epoch_stats(record, deferred.drain([record])[0])

    def _dispatch_eval(self, loader: HostLoader) -> Dict:
        """An eval epoch's steps, without a read: {"out": {"loss" [batches],
        "inter", "union" [batches, B, C]} on the device, "rows": index rows
        (-1 = padding), "groups": scan names (one per batch, or one per slice
        with `packed_eval`)}."""
        packed = int(self._trainer_cfg().get("packed_eval") or 0)
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
        out = ({k: torch.stack([o[k] for o in pending]) for k in ("loss", "inter", "union")}
               if pending else {})
        return {"out": out, "rows": rows, "groups": groups}

    def _eval_stats(self, record: Dict, host: Dict) -> Tuple[Dict, float]:
        """(eval meters' statistics, val DSC_mean) from an eval epoch's record
        and its drained outputs."""
        C = self._model.num_classes
        meters = MeterInterface(default_focus="eval")
        meters.register_meter("loss", AverageValueMeter())
        dice = meters.register_meter("dice", UniversalDice(C, report_axises=list(range(1, C))))
        stacked = host["out"]
        for b, (row, group) in enumerate(zip(record["rows"], record["groups"])):
            meters["loss"].add(float(stacked["loss"][b]))
            keep = np.asarray(row) >= 0
            if isinstance(group, list):  # packed_eval: a scan name per slice
                group = [g for g, k in zip(group, keep) if k]
            dice.add(stacked["inter"][b][keep], stacked["union"][b][keep], group_name=group)
        stats = meters.statistics("eval")
        return stats, float(stats["dice"]["DSC_mean"])

    def _run_eval_epoch(self, loader: HostLoader) -> Tuple[Dict, float]:
        record = self._dispatch_eval(loader)
        return self._eval_stats(record, deferred.drain([{"out": record["out"]}])[0])

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
        if self._defer_reads:
            return self._start_training_deferred()
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        for self._cur_epoch in range(start, self._max_epoch + 1):
            record = self._dispatch_maybe_profiled(start)
            train_stats = self._epoch_stats(record, deferred.drain([record])[0])
            self.last_epoch_stats = train_stats
            val_stats, cur_score = self._run_eval_epoch(self._val_loader)
            test_stats, _ = (self._run_eval_epoch(self._test_loader)
                             if self._test_loader is not None else ({}, 0.0))
            # the epoch's row and the hooks' scheduler steps go in before the
            # checkpoints, so that they hold the state a resumed run continues
            # from (spcl_tpu writes them after, and its checkpoints lag by one)
            self._put_epoch(self._cur_epoch, train_stats, val_stats, test_stats)
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

    def _put_epoch(self, epoch: int, train_stats: Dict, val_stats: Dict,
                   test_stats: Dict) -> None:
        """The epoch's storage row (storage.csv) and TensorBoard scalars."""
        self._storage.put_epoch(epoch, {**train_stats, "val": val_stats, "test": test_stats})
        self._storage.flush()
        self._writer.add_scalars_from_meter_interface(epoch, **train_stats, val=val_stats,
                                                      test=test_stats)

    # ----------------------------------------------------------------- deferred
    def _start_training_deferred(self) -> float:
        """`Trainer.defer_reads` (spcl_tpu `_start_training_deferred`,
        trainer.py:755-882): the epochs run without a device -> host read.
        Each epoch's val score is computed on the device and the best epoch's
        checkpoint state kept there (`deferred.DeviceBest`); the drain at the
        end (and at each `flush_every`) rebuilds the epochs' storage rows,
        meters and TensorBoard scalars from one copy per metric and writes the
        checkpoints the eager loop writes."""
        self._check_deferred()
        flush_every = int(self._trainer_cfg().get("flush_every") or 0)
        start = self._cur_epoch + 1 if self._cur_epoch else 1
        if start > self._max_epoch:
            # resumed at max_epoch: nothing to train; last.ckpt as restored
            self.save_to("last.ckpt")
            self._finish()
            return float(self._best_score)
        # the device's best so far starts at the restored one (a resumed run)
        self._device_best_score = float(np.float32(self._best_score))
        best = deferred.DeviceBest(self._device, self._device_best_score)
        records: List[Dict] = []
        for self._cur_epoch in range(start, self._max_epoch + 1):
            record = {"train": self._dispatch_maybe_profiled(start),
                      "val": self._dispatch_eval(self._val_loader),
                      "test": (self._dispatch_eval(self._test_loader)
                               if self._test_loader is not None else None)}
            record["score"] = deferred.device_val_score(
                record["val"]["out"], record["val"]["rows"], record["val"]["groups"],
                self._model.num_classes)
            records.append(record)
            for h in self._hooks:
                h.on_epoch_end()
            best.update(self._cur_epoch, record["score"], self._checkpoint_state())
            if flush_every and self._cur_epoch % flush_every == 0 \
                    and self._cur_epoch < self._max_epoch:
                self._drain_epochs(records, best)
                self.save_to("last.ckpt")
        self._drain_epochs(records, best)
        self.save_to("last.ckpt")
        self._log("deferred run done | best val DSC %.4f (on the device %.4f)",
                  self._best_score, self._device_best_score)
        self._finish()
        return float(self._best_score)

    def _drain_epochs(self, records: List[Dict], best: "deferred.DeviceBest") -> None:
        """One copy per metric of the deferred epochs; their storage rows and
        TensorBoard scalars; `best.ckpt` as the eager loop writes it at the
        best of them (the device's choice, replayed from the drained scores)."""
        hosts = deferred.drain([{"train": r["train"]["metrics"], "val": r["val"]["out"],
                                 "test": None if r["test"] is None else r["test"]["out"],
                                 "score": r["score"]} for r in records])
        best_epoch, best_score, best_storage = None, None, None
        device_best = self._device_best_score
        for r, host in zip(records, hosts):
            epoch = r["train"]["epoch"]
            train_stats = self._epoch_stats(r["train"], {"metrics": host["train"]})
            self.last_epoch_stats = train_stats
            val_stats, cur_score = self._eval_stats(r["val"], {"out": host["val"]})
            test_stats = (self._eval_stats(r["test"], {"out": host["test"]})[0]
                          if r["test"] is not None else {})
            self._put_epoch(epoch, train_stats, val_stats, test_stats)
            if host["score"] > device_best:  # the device's select, replayed
                device_best = float(host["score"])
                best_epoch, best_score = epoch, cur_score
                best_storage = copy.deepcopy(self._storage.state_dict())
            self._log("epoch %03d | val DSC %.4f (device %.4f) | %s", epoch, cur_score,
                      float(host["score"]), meter_display(train_stats))
        self._device_best_score = device_best
        if best_epoch is not None:
            self._best_score = best_score
            state = best.state(best_epoch)
            state["best_score"] = float(best_score)
            state["storage"] = best_storage
            if self._is_master:
                save_checkpoint(str(Path(self._save_dir) / "best.ckpt"), state)
        records.clear()

    @property
    def device_best_score(self) -> float:
        """The best val score as the deferred loop's device select saw it
        (float32); -inf before a deferred run."""
        return getattr(self, "_device_best_score", -np.inf)

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
    Hooks are not activated (spcl_tpu's step reads none). `defer_reads` is
    ignored: the two-optimizer loop runs eagerly, as spcl_tpu's does
    (trainer.py:1056)."""
    activate_hooks = False

    def __init__(self, *, reg_weight: float = 0.01, dis_consider_image: bool = False,
                 discr_lr: float = 1e-4, **kwargs):
        if kwargs.get("defer_reads"):
            logger.info("Trainer.defer_reads: the adversarial trainer runs eagerly")
        kwargs["defer_reads"] = False
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
        if self._n_shards > 1:
            mesh_lib.broadcast_tensors(list(self._discriminator.state_dict().values()))
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
