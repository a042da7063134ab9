"""Functions that run inside the ranks of the multi-rank tests
(tests/test_torch_parallel_*.py), started with
`spcl_torch.parallel.mesh.spawn_local` over gloo on the CPU. The rank
processes import this module by name, so it imports torch, numpy and
spcl_torch only — never jax or spcl_tpu, which the rank processes must not
need. Inputs and outputs are numpy arrays and plain python values."""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch

from spcl_torch.data import create_contrastive_loader, get_data, synthetic_dataset
from spcl_torch.data.augment import AugmentPolicy
from spcl_torch.hooks import SelfPacedINFONCEHook, feature_until_from_hooks
from spcl_torch.models import UNet, set_trainable_stages, stages_from_range
from spcl_torch.models.norm import CrossRankBatchNorm2d
from spcl_torch.ops.supcon_cuda import sharded_fused_self_paced_supcon
from spcl_torch.parallel import mesh
from spcl_torch.parallel.contrastive import (global_self_paced_supcon,
                                             sharded_self_paced_supcon)
from spcl_torch.training import (FineTuneTrainer, PretrainEncoderTrainer, build_optimizer,
                                 build_gradcache_pretrain_step, build_pretrain_step)

CANVAS, CROP, MAXC = 48, 32, 64
OPTIM = {"Optim": {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5}}
SP_HOOK = "spinfonce/Conv5/partition"

LOSSES = {
    "fused_strip": sharded_fused_self_paced_supcon,
    "naive_strip": lambda *a, **k: sharded_self_paced_supcon(*a, use_fused=False, **k),
    "replicated": lambda *a, **k: global_self_paced_supcon(*a, use_fused=True, **k),
    "replicated_dense": lambda *a, **k: global_self_paced_supcon(*a, use_fused=False, **k),
}


def _my_rows(x):
    return mesh.shard_rows(x, x.shape[0])


def supcon_worker(problem, cases, gamma):
    """Every (loss name, mode, correct_grad) of `cases` on this rank's rows of
    the global problem: {case: (loss, ratio, dz1 rows, dz2 rows)}."""
    torch.set_num_threads(1)
    out = {}
    for name, mode, correct_grad in cases:
        z1 = torch.from_numpy(_my_rows(problem["z1"])).requires_grad_(True)
        z2 = torch.from_numpy(_my_rows(problem["z2"])).requires_grad_(True)
        loss, ratio = LOSSES[name](
            z1, z2, torch.from_numpy(_my_rows(problem["labels"])),
            torch.from_numpy(_my_rows(problem["valid"])), gamma=gamma, weight_update=mode,
            correct_grad=correct_grad)
        loss.backward()
        out[(name, mode, correct_grad)] = (float(loss.detach()), float(ratio), z1.grad.numpy(),
                                           z2.grad.numpy())
    return out


def batchnorm_worker(x, dy, weight, bias, running_mean, running_var):
    """Train-mode forward and backward of the cross-rank BatchNorm on this
    rank's rows of x [B, C, H, W], for the loss sum(y * dy)."""
    torch.set_num_threads(1)
    bn = CrossRankBatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(running_mean))
        bn.running_var.copy_(torch.from_numpy(running_var))
    bn.train()
    xl = torch.from_numpy(_my_rows(x)).requires_grad_(True)
    y = bn(xl)
    (y * torch.from_numpy(_my_rows(dy))).sum().backward()
    bn.eval()
    y_eval = bn(xl.detach())
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(), "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy(), "y_eval": y_eval.detach().numpy(),
            "tracked": int(bn.num_batches_tracked)}


# ------------------------------------------------------------------ trainers
class _Pretrain(PretrainEncoderTrainer):
    @property
    def train_policy(self):
        return AugmentPolicy(crop=CROP, rot_degrees=20.0, jitter=True)


class _FineTune(FineTuneTrainer):
    @property
    def train_policy(self):
        return AugmentPolicy(crop=CROP, rot_degrees=20.0, jitter=True)


def _datasets():
    tra = synthetic_dataset("acdc", num_scans=8, slices_per_scan=(6, 8), canvas=CANVAS, seed=0)
    test = synthetic_dataset("acdc", num_scans=4, slices_per_scan=(6, 8), canvas=CANVAS,
                             seed=1, mode="val")
    return tra, test


def _rank_dir(save_dir):
    """Each rank gets a directory of its own, so that a test can see which
    rank wrote what."""
    return str(Path(save_dir) / f"rank{mesh.rank()}")


def run_pretrain(save_dir, n_ranks, global_contrast="replicated", layout="nhwc",
                 init_only=False):
    """2 epochs x 2 steps of SP-InfoNCE pretraining (12 slices per step)."""
    torch.manual_seed(0)
    tra, _ = _datasets()
    loader = create_contrastive_loader(tra, scan_sample_num=4, seed=0)
    model = UNet(input_dim=1, num_classes=4, max_channel=MAXC, small_c_layout=layout)
    hook = SelfPacedINFONCEHook(name=SP_HOOK, feature_name="Conv5", contrast_on="partition",
                                begin_value=1e4, end_value=20, mode="soft", max_epoch=2,
                                global_contrast=global_contrast)
    until = feature_until_from_hooks(hook)
    tr = _Pretrain(model=model, save_dir=_rank_dir(save_dir), max_epoch=2, num_batches=2,
                   config=dict(OPTIM), crop=CROP, data_name="acdc", contrastive_loader=loader,
                   forward_until=until, device="cpu", mesh=n_ranks if n_ranks > 1 else 0)
    tr.register_hooks(hook)
    tr.set_trainable_stages(stages_from_range(None, until))
    tr.init()
    if init_only:
        return tr
    tr.start_training()
    return {"n_shards": tr.n_shards,
            "reg_loss": [m["reg_loss"] for m in tr.step_metrics],
            "sp_weight": [m["hooks"][SP_HOOK]["sp_weight"] for m in tr.step_metrics],
            "age_param": [m["hooks"][SP_HOOK]["age_param"] for m in tr.step_metrics],
            "conv5": model._Conv5.conv[0].weight.detach().numpy().copy(),
            "running_var": model._Conv5.conv[1].running_var.numpy().copy(),
            "files": _files(tr.save_dir)}


def run_finetune(save_dir, n_ranks, batch_size=8):
    """1 epoch x 2 labeled steps of the whole UNet, then eval on the val loader."""
    torch.manual_seed(0)
    tra, test = _datasets()
    lab, _, val, _ = get_data(tra_set=tra, test_set=test, labeled_scan_num=4,
                              labeled_batch_size=batch_size, unlabeled_batch_size=8,
                              load_predefined_list=False, pad_eval_to=8)
    model = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    tr = _FineTune(model=model, labeled_loader=lab, val_loader=val, test_loader=None,
                   save_dir=_rank_dir(save_dir), max_epoch=1, num_batches=2,
                   config=dict(OPTIM), crop=CROP, data_name="acdc", device="cpu",
                   mesh=n_ranks if n_ranks > 1 else 0)
    tr.init()
    score = tr.start_training()
    return {"score": score, "n_shards": tr.n_shards,
            "sup_loss": [m["sup_loss"] for m in tr.step_metrics],
            "conv1": model._Conv1.conv[0].weight.detach().numpy().copy(),
            "history": tr._storage.history[1], "files": _files(tr.save_dir)}


def _files(save_dir):
    return sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else []


def trainer_worker(save_dir, n_ranks):
    """Every trainer scenario of tests/test_torch_parallel_trainer.py in one
    set of ranks (starting ranks costs seconds): {scenario: result}."""
    torch.set_num_threads(1)
    out = {}
    for contrast in ("replicated", "row_sharded"):
        out[f"pretrain_{contrast}"] = run_pretrain(Path(save_dir) / contrast, n_ranks, contrast)
    out["finetune"] = run_finetune(Path(save_dir) / "ft", n_ranks)
    out["finetune_padded"] = run_finetune(Path(save_dir) / "ft5", n_ranks, batch_size=5)
    try:
        run_pretrain(Path(save_dir) / "pallas", n_ranks, layout="pallas", init_only=True)
        out["pallas_refused"] = None
    except ValueError as e:
        out["pallas_refused"] = str(e)
    return out


def pretrain_step_worker(state_dict, head_state, batch, draws, gamma, lr, wd, global_contrast):
    """One pretrain step on this rank's rows of a fixed global batch with
    injected global draws, from the given weights (numpy state_dicts)."""
    torch.set_num_threads(1)
    from spcl_torch.data import augment as aug
    net = UNet(input_dim=1, num_classes=4, max_channel=128)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                                begin_value=3, end_value=14, max_epoch=2,
                                global_contrast=global_contrast)
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v) for k, v in head_state.items()})
    params = [p for p in net.parameters() if p.requires_grad] + hook.parameters()
    opt = build_optimizer(params, lr=lr, weight_decay=wd)
    step = build_pretrain_step(net, [hook], opt,
                               policy=dataclasses.replace(aug.ACDC_PRETRAIN, crop=32),
                               total_freedom=True, until="Conv5")
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, None,
                   {"sp": {"gamma": gamma}}, params=_to_torch(draws))
    named = dict(net.named_parameters())
    named.update({f"head.{k}": v for k, v in hook.projector.named_parameters()})
    return {"reg_loss": float(metrics["reg_loss"]),
            "sp_weight": float(metrics["hooks"]["sp"]["sp_weight"]),
            "params": {k: v.detach().numpy().copy() for k, v in named.items()
                       if v.requires_grad},
            "grads": {k: v.grad.numpy().copy() for k, v in named.items()
                      if v.grad is not None}}


def gradcache_worker(state_dict, head_state, batch, num_chunks):
    """The cached value and gradient of one gradient-cache pretrain step in
    deterministic geometry (crop = canvas, no rotation, flips or jitter) on
    this rank's rows of a fixed global batch, from the given weights: loss,
    sp_weight and every parameter gradient, summed over ranks."""
    torch.set_num_threads(1)
    net = UNet(input_dim=1, num_classes=4, max_channel=128)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", contrast_on="partition",
                                begin_value=50.0, end_value=5.0, mode="soft", max_epoch=2,
                                global_contrast="row_sharded")
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v) for k, v in head_state.items()})
    named = {k: v for k, v in net.named_parameters() if v.requires_grad}
    named.update({f"head.{k}": v for k, v in hook.projector.named_parameters()})
    opt = build_optimizer(list(named.values()), name="adam", lr=1e-3)
    canvas = batch["image"].shape[-1]
    policy = AugmentPolicy(crop=canvas, rot_degrees=0.0, hflip=False, vflip=False,
                           jitter=False)
    step = build_gradcache_pretrain_step(net, [hook], opt, policy=policy, total_freedom=True,
                                         until="Conv5", num_chunks=num_chunks,
                                         flip_threshold=0.0)
    out = step.cached_value_and_grad({k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0),
                                     {"sp": hook.epoch_scalars(0)})
    return {"loss": float(out["loss"]), "sp_weight": float(out["hooks"]["sp"]["sp_weight"]),
            "grads": {k: g.numpy() for k, g in zip(named, out["grads"])}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def failing_worker():
    """Rank 1 raises; rank 0 would wait for it in a collective for ever."""
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_reduce_sum(torch.ones(1))
    return True


def hanging_worker():
    """Rank 1 never reaches the collective that rank 0 waits in."""
    import time
    if mesh.rank() == 1:
        time.sleep(3600)
    mesh.all_reduce_sum(torch.ones(1))
    return True


def run_calls(calls):
    """[(function name, args), ...] of this module in one set of ranks
    (starting ranks costs seconds): the list of their results."""
    return [globals()[name](*args) for name, args in calls]


# ------------------------------------------------------------------ semi, mixup, adv, decoder
# (tests/test_torch_parallel_semi.py): the steps on fixed global batches with
# the step's own generator, the same weights from one seed in every process
SEMI_MAXC = 32
SEMI_LR, SEMI_WD = 1e-3, 1e-5
MT_UDA = {"MeanTeacherParams": {"weight": 10.0, "alpha": 0.999},
          "ConsistencyParams": {"weight": 5.0}}


def _infonce(global_contrast, feature="Conv5", contrast="partition"):
    return {"InfonceParams": {"feature_names": feature, "weights": 1.0,
                              "contrast_ons": contrast, "global_contrast": global_contrast}}


def semi_scenarios():
    """{scenario: (hook config blocks, steps)} of the semi step under a mesh."""
    from spcl_torch.hooks import LEGACY_TRAINER_PRESETS as presets
    return {
        "mt_uda": (MT_UDA, 2),
        "entropy": (presets["entropy"], 1),
        "ucmeanteacher": ({"UCMeanTeacherParams": {"weight": 1.0, "threshold_begin": 0.9,
                                                   "threshold_end": 0.9}}, 1),
        "iic": (presets["iic"], 1),
        "udaiic": (presets["udaiic"], 1),
        "midl": (presets["midl"], 1),
        "mine": (presets["mine"], 1),
        "mixup": ({**MT_UDA, "MixUpParams": {"weight": 0.5}}, 1),
        "infonce_replicated": (_infonce("replicated"), 1),
        "infonce_row_sharded": (_infonce("row_sharded"), 1),
    }


def _label_policy():
    from spcl_torch.data import augment as aug
    return dataclasses.replace(aug.ACDC_LABEL, crop=CROP)


def _index_batches(steps, sizes, seed=21):
    """`steps` tuples of global index vectors (one per size), each right-
    padded with -1 (valid 0) to a multiple of 2 ranks."""
    ds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    rng = np.random.default_rng(seed)
    return ds, [tuple(mesh.pad_multiple(rng.choice(len(ds.images), n, replace=False), 2)
                      for n in sizes) for _ in range(steps)]


def _host(tree):
    """Detached numpy (or float) copies of a metrics tree."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().numpy().copy()
    return tree


def _weights(model, hooks=(), extra=None):
    out = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for h in hooks:
        if h.projector is not None:
            out.update({f"hook:{h.name}.{k}": v.detach().numpy().copy()
                        for k, v in h.projector.state_dict().items()})
    for name, module in (extra or {}).items():
        out.update({f"{name}.{k}": v.detach().numpy().copy()
                    for k, v in module.state_dict().items()})
    return out


def run_semi_step(blocks, steps, n_l=4, n_u=3):
    """`steps` semi steps of the hooks of `blocks` on this rank's rows of
    fixed global batches (the unlabeled one padded), drawing from one
    generator: {"metrics": [per step], "weights", "teacher"}."""
    from spcl_torch.hooks import create_hook_from_config
    from spcl_torch.models import EMATeacher
    from spcl_torch.training import batch_to_device, build_semi_step
    torch.manual_seed(0)
    model = UNet(input_dim=1, num_classes=4, max_channel=SEMI_MAXC)
    hooks = create_hook_from_config(blocks, max_epoch=2)
    for h in hooks:
        h.build(model, "cpu")
    opt = build_optimizer(list(model.parameters()) + [p for h in hooks for p in h.parameters()],
                          lr=SEMI_LR, weight_decay=SEMI_WD)
    alphas = sorted({h.alpha for h in hooks if h.needs_teacher})
    teacher = EMATeacher(model, alphas[0]) if alphas else None
    step = build_semi_step(model, hooks, opt, num_classes=4, policy=_label_policy(),
                           teacher=teacher)
    gen = torch.Generator().manual_seed(5)
    scalars = {h.name: h.epoch_scalars(0) for h in hooks}
    ds, batches = _index_batches(steps, (n_l, n_u))
    metrics = [_host(step(batch_to_device(ds.batch(il), "cpu"),
                          batch_to_device(ds.batch(iu), "cpu"), gen, scalars))
               for il, iu in batches]
    return {"metrics": metrics, "weights": _weights(model, hooks),
            "teacher": None if teacher is None else _weights(teacher.model),
            "hook_grads": {f"{h.name}.{k}": p.grad.numpy().copy()
                           for h in hooks if h.projector is not None
                           for k, p in h.projector.named_parameters()}}


def run_finetune_hooks_step(alpha, steps=2, n=3):
    """The mixup trainer's step: `build_finetune_step` with a MixUp hook
    (Beta(alpha, alpha)) on two labeled views."""
    from spcl_torch.hooks import MixUpHook
    from spcl_torch.training import batch_to_device, build_finetune_step
    torch.manual_seed(0)
    model = UNet(input_dim=1, num_classes=4, max_channel=SEMI_MAXC)
    hook = MixUpHook(weight=0.5, alpha=alpha)
    opt = build_optimizer(list(model.parameters()), lr=SEMI_LR, weight_decay=SEMI_WD)
    step = build_finetune_step(model, opt, num_classes=4, policy=_label_policy(), hooks=[hook])
    gen = torch.Generator().manual_seed(6)
    ds, batches = _index_batches(steps, (n,))
    metrics = [_host(step(batch_to_device(ds.batch(i), "cpu"), gen, hook_scalars={}))
               for (i,) in batches]
    return {"metrics": metrics, "weights": _weights(model)}


def _discriminator():
    from spcl_torch.models import Discriminator
    torch.manual_seed(1)
    return Discriminator(5)


def initial_discriminator():
    """The weights `run_adversarial_step` starts its discriminator from."""
    return _weights(_discriminator())


def run_adversarial_step(reg_weight=0.5, steps=1, n_l=3, n_u=3):
    """`build_adversarial_step` with `dis_consider_image`: the student and
    the discriminator after `steps` steps (one: the discriminator's Adam
    moves a weight by about lr x sign(g), and where g sits at its rounding
    noise two summation orders move it apart by 2 lr, which the next step's
    losses carry)."""
    from spcl_torch.training import Adam, batch_to_device, build_adversarial_step
    torch.manual_seed(0)
    model = UNet(input_dim=1, num_classes=4, max_channel=SEMI_MAXC)
    d = _discriminator()
    opt = build_optimizer(list(model.parameters()), lr=SEMI_LR, weight_decay=SEMI_WD)
    dopt = Adam(d.parameters(), lr=1e-3, betas=(0.5, 0.999))
    step = build_adversarial_step(model, d, opt, dopt, num_classes=4, policy=_label_policy(),
                                  reg_weight=reg_weight, dis_consider_image=True)
    gen = torch.Generator().manual_seed(7)
    ds, batches = _index_batches(steps, (n_l, n_u))
    metrics = [_host(step(batch_to_device(ds.batch(il), "cpu"),
                          batch_to_device(ds.batch(iu), "cpu"), gen))
               for il, iu in batches]
    return {"metrics": metrics, "weights": _weights(model),
            "discriminator": _weights(d),
            "d_moments": [dopt.state[p]["mu"].numpy().copy() for p in d.parameters()]}


DECODER_HOOK = "infonce/Up_conv3/self"


def run_decoder_step(global_contrast, steps=2):
    """`pretrain_decoder` steps: the dense InfoNCE hook at Up_conv3
    (`contrast_on: self`), Conv5..Up_conv3 trained, both views sharing one
    geometry, on contrastive batches of 3 scans x 3 partitions (9 slices
    padded to 10)."""
    from spcl_torch.data import augment as aug
    from spcl_torch.hooks import INFONCEHook
    from spcl_torch.training import batch_to_device
    torch.manual_seed(0)
    model = UNet(input_dim=1, num_classes=4, max_channel=SEMI_MAXC)
    set_trainable_stages(model, stages_from_range("Conv5", "Up_conv3"))
    hook = INFONCEHook(name=DECODER_HOOK, feature_name="Up_conv3", contrast_on="self",
                       global_contrast=global_contrast)
    hook.build(model, "cpu")
    opt = build_optimizer([p for p in model.parameters() if p.requires_grad]
                          + hook.parameters(), lr=SEMI_LR, weight_decay=1e-2)
    step = build_pretrain_step(model, [hook], opt,
                               policy=dataclasses.replace(aug.ACDC_PRETRAIN, crop=CROP),
                               total_freedom=False, until="Up_conv3")
    tra, _ = _datasets()
    loader = create_contrastive_loader(tra, scan_sample_num=3, seed=0)
    gen = torch.Generator().manual_seed(8)
    metrics = []
    for _, idx in zip(range(steps), loader.sampler):
        batch = tra.batch(mesh.pad_multiple(np.asarray(idx), 2))
        metrics.append(_host(step(batch_to_device(batch, "cpu"), gen, {})))
    return {"metrics": metrics, "weights": _weights(model, [hook])}


def _semi_config(save_dir, n_ranks, max_epoch=2, **trainer):
    """A tiny semi configuration (mean teacher + consistency + UC-MT) for
    `build_trainer`."""
    return {
        "RandomSeed": 3,
        "Arch": {"max_channel": SEMI_MAXC, "small_c_layout": "nhwc"},
        "Optim": {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5},
        "Data": {"name": "acdc", "labeled_scan_num": 2, "canvas": CANVAS, "crop": CROP,
                 "synthetic": True, "synthetic_scans": 4, "synthetic_test_scans": 3},
        "LabeledLoader": {"batch_size": 4}, "UnlabeledLoader": {"batch_size": 4},
        "Trainer": {"name": "semi", "num_batches": 2, "max_epoch": max_epoch,
                    "save_dir": str(save_dir), "mesh": n_ranks if n_ranks > 1 else 0,
                    **trainer},
        **MT_UDA,
        "UCMeanTeacherParams": {"weight": 1.0, "threshold_begin": 0.5, "threshold_end": 0.9},
    }


def _semi_run_record(trainer):
    return {"score": float(trainer.best_score), "n_shards": trainer.n_shards,
            "steps": [{k: v for k, v in m.items()} for m in trainer.step_metrics],
            "weights": _weights(trainer.model), "teacher": _weights(trainer.teacher.model),
            "history": trainer._storage.history, "files": _files(trainer.save_dir)}


def run_semi_trainer(save_dir, n_ranks):
    """The semi trainer through `build_trainer`: 2 epochs x 2 steps (the
    epoch-1 last.ckpt kept), then a run resumed from it into epoch 2, then 2
    epochs with `defer_reads`."""
    import shutil
    from spcl_torch.entry import build_trainer as build
    from spcl_torch.utils import fix_all_seed

    def build_trainer(config, device):  # as spcl_torch.main.run_rank seeds it
        fix_all_seed(config["RandomSeed"])
        return build(config, device=device)

    save_dir = Path(save_dir)
    out = {}
    full = build_trainer(_semi_config(_rank_dir(save_dir / "full"), n_ranks), device="cpu")
    full.init()
    save_to = full.save_to

    def keep_epoch_1(name):
        save_to(name)
        if name == "last.ckpt" and full._cur_epoch == 1 and mesh.on_master():
            shutil.copy(Path(full.save_dir) / name, save_dir / "epoch1.ckpt")

    full.save_to = keep_epoch_1
    full.start_training()
    out["full"] = _semi_run_record(full)
    resumed = build_trainer(_semi_config(_rank_dir(save_dir / "resumed"), n_ranks),
                            device="cpu")
    resumed.init()
    resumed.resume_from_path(str(save_dir / "epoch1.ckpt"))
    out["resumed_at"] = resumed._cur_epoch
    resumed.start_training()
    out["resumed"] = _semi_run_record(resumed)
    deferred = build_trainer(_semi_config(_rank_dir(save_dir / "deferred"), n_ranks,
                                          defer_reads=True), device="cpu")
    deferred.init()
    deferred.start_training()
    out["deferred"] = _semi_run_record(deferred)
    return out


def semi_worker(save_dir, n_ranks):
    """Every scenario of tests/test_torch_parallel_semi.py in one set of
    ranks (or, with n_ranks 1, in this process): {scenario: result}."""
    torch.set_num_threads(1)
    out = {f"semi_{name}": run_semi_step(blocks, steps)
           for name, (blocks, steps) in semi_scenarios().items()}
    for alpha in (1.0, 0.4):
        out[f"finetune_mixup_{alpha}"] = run_finetune_hooks_step(alpha)
    out["adversarial"] = run_adversarial_step()
    for contrast in ("replicated", "row_sharded"):
        out[f"decoder_{contrast}"] = run_decoder_step(contrast)
    out["trainer"] = run_semi_trainer(save_dir, n_ranks)
    return out


def _without_tensorflow():
    """Let this (rank or helper) process write its TensorBoard events through
    tensorboard's own stub: `torch.utils.tensorboard` imports tensorflow
    where it is installed, ~10 s a process."""
    sys.modules.setdefault("tensorflow", None)


def semi_rank_worker(save_dir, n_ranks):
    """`semi_worker` in a process of its own (a rank, or the single process
    beside the ranks)."""
    _without_tensorflow()
    return semi_worker(save_dir, n_ranks)


def main_entry(argv):
    """`spcl_torch.main.main(argv, device="cpu")` in a process of its own, on
    one torch thread."""
    _without_tensorflow()
    torch.set_num_threads(1)
    from spcl_torch.main import main
    return main(argv, device="cpu")


# ------------------------------------------------------------------ against spcl_tpu (one step
# on a fixed global batch with spcl_tpu's draws injected, from transplanted weights)
def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)


def semi_parity_worker(spec, state_dict, head_states, batch_l, batch_u, draws, scalars):
    """One semi step of the hooks made by `spec` ([(factory, kwargs)]) from
    the given weights (the teacher a copy of the student)."""
    torch.set_num_threads(1)
    from spcl_torch.data import augment as aug
    from spcl_torch.hooks import creator, get_individual_hooks
    from spcl_torch.models import EMATeacher
    from spcl_torch.training import build_semi_step
    net = UNet(input_dim=1, num_classes=4, max_channel=128)
    _load(net, state_dict)
    hooks = get_individual_hooks(*[getattr(creator, f)(**kw) for f, kw in spec])
    for h in hooks:
        h.build(net, "cpu")
        if h.name in head_states:
            _load(h.projector, head_states[h.name])
    opt = build_optimizer(list(net.parameters()) + [p for h in hooks for p in h.parameters()],
                          lr=SEMI_LR, weight_decay=SEMI_WD)
    teacher = EMATeacher(net)
    step = build_semi_step(net, hooks, opt, num_classes=4,
                           policy=dataclasses.replace(aug.ACDC_LABEL, crop=CROP),
                           teacher=teacher)
    m = step(_to_torch(batch_l), _to_torch(batch_u), None, scalars, params=_to_torch(draws))
    return {"metrics": _host(m), "weights": _weights(net, hooks),
            "teacher": _weights(teacher.model)}


def adversarial_parity_worker(state_dict, d_state, batch_l, batch_u, draws, reg_weight):
    """One adversarial step (`dis_consider_image`) from the given weights:
    the metrics, the student, the discriminator and the gradients its Adam
    saw."""
    torch.set_num_threads(1)
    from spcl_torch.data import augment as aug
    from spcl_torch.models import Discriminator
    from spcl_torch.training import Adam, build_adversarial_step
    net = UNet(input_dim=1, num_classes=4, max_channel=128)
    _load(net, state_dict)
    d = Discriminator(5)
    _load(d, d_state)
    opt = build_optimizer(list(net.parameters()), lr=SEMI_LR, weight_decay=SEMI_WD)
    dopt = Adam(d.parameters(), lr=1e-4, betas=(0.5, 0.999))
    step = build_adversarial_step(net, d, opt, dopt, num_classes=4,
                                  policy=dataclasses.replace(aug.ACDC_LABEL, crop=CROP),
                                  reg_weight=reg_weight, dis_consider_image=True)
    m = step(_to_torch(batch_l), _to_torch(batch_u), None, params=_to_torch(draws))
    return {"metrics": _host(m), "weights": _weights(net, extra={"discriminator": d}),
            "d_grads": {k: p.grad.numpy().copy() for k, p in d.named_parameters()}}


def decoder_parity_worker(state_dict, head_state, batch, draws, global_contrast):
    """One `pretrain_decoder` step (Up_conv3, `contrast_on: self`) from the
    given weights, spcl_tpu's draws (its dense points for the global batch)
    injected."""
    torch.set_num_threads(1)
    from spcl_torch.data import augment as aug
    from spcl_torch.hooks import INFONCEHook
    net = UNet(input_dim=1, num_classes=4, max_channel=128)
    _load(net, state_dict)
    set_trainable_stages(net, stages_from_range("Conv5", "Up_conv3"))
    hook = INFONCEHook(name=DECODER_HOOK, feature_name="Up_conv3", contrast_on="self",
                       global_contrast=global_contrast)
    hook.build(net, "cpu")
    _load(hook.projector, head_state)
    opt = build_optimizer([p for p in net.parameters() if p.requires_grad] + hook.parameters(),
                          lr=SEMI_LR, weight_decay=1e-2)
    step = build_pretrain_step(net, [hook], opt,
                               policy=dataclasses.replace(aug.ACDC_PRETRAIN, crop=CROP),
                               total_freedom=False, until="Up_conv3")
    m = step(_to_torch(batch), None, {}, params=_to_torch(draws))
    return {"metrics": _host(m), "weights": _weights(net, [hook])}


def build_trainers_worker(configs, save_dir):
    """`build_trainer` + `init()` of every {name: config} (each with
    Trainer.mesh) in this rank: {name: what was built}."""
    torch.set_num_threads(1)
    _without_tensorflow()
    from spcl_torch.entry import build_trainer
    out = {}
    for name, config in configs.items():
        trainer = build_trainer(config, save_dir=_rank_dir(Path(save_dir) / name),
                                pretrain=name.startswith("pretrain"), device="cpu")
        trainer.init()
        out[name] = {"type": type(trainer).__name__, "n_shards": trainer.n_shards,
                     "hooks": [h.name for h in trainer.hooks],
                     "teacher": trainer.teacher is not None,
                     "conv1": trainer.model._Conv1.conv[0].weight.detach().numpy().copy()}
    return out
