"""Functions that run inside the ranks of the multi-rank tests
(tests/test_torch_parallel_*.py), started with
`spcl_torch.parallel.mesh.spawn_local` over gloo on the CPU. The rank
processes import this module by name, so it imports torch, numpy and
spcl_torch only — never jax or spcl_tpu, which the rank processes must not
need. Inputs and outputs are numpy arrays and plain python values."""
import dataclasses
import os
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
