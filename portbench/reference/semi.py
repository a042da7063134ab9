"""The plain reference of the mean-teacher semi step (and the Dice
statistics of its labeled prediction): one augmented view of
the labeled slices (image bilinear, label nearest), two views of the
unlabeled ones sharing one geometry, the second flipped; the whole UNet in
train mode on [labeled, unlabeled, flipped unlabeled]; the pixel-mean
cross-entropy of the labeled view; the teacher (the student's weights
averaged, batch statistics) on the plain unlabeled view, flipped; the
mean-teacher loss, the mean squared difference of the two softmaxes, times
its weight; the backward; RAdam with L2 decay over every UNet leaf; then
teacher <- alpha teacher + (1 - alpha) student, alpha = min(1 - 1/(k + 2),
alpha_max) after step k.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import ops


def follow(inputs: Dict, feeds: List[Dict], config: Dict, program: Dict, epoch: int,
           kind: str, device) -> Dict:
    """The reference's run of the checked steps: {"losses": [{"sup_loss",
    "reg_loss"}], "answers": [{"inter", "union"}], "first_grad",
    "first_raw", "after" (with `teacher.*`)}."""
    policy = config["augment"]["label"]
    crop, rac = int(policy["crop"]), bool(policy["rotate_after_crop"])
    mt = program["MeanTeacherParams"]
    ncls = int(program["Arch"]["num_classes"])
    names = ops.leaf_names(inputs["weights"], None, head_too=False)
    w = {k: v.to(device).clone() for k, v in inputs["weights"].items()}
    teacher = {k: w[k].clone() for k in names}
    opt = ops.RAdam(names, float(program["Optim"]["weight_decay"]))
    lr = ops.epoch_lr(program, epoch)
    out = {"losses": [], "answers": []}
    for s, feed in enumerate(feeds):
        rows_l, rows_u = feed["rows"]
        p = feed["params"]
        x_l = ops.gather_images(inputs["images"], rows_l, device)
        y_l = torch.as_tensor(inputs["labels"][rows_l], device=device).long()
        x_u = ops.gather_images(inputs["images"], rows_u, device)
        img_l = ops.view(x_l, p["lab"]["geo"], p["lab"].get("jitter"), policy)
        lab_l = ops.warp_label(y_l, p["lab"]["geo"], crop, rac)
        img_u = ops.view(x_u, p["unl"]["geo1"], p["unl"].get("jitter1"), policy)
        img_u_tf = ops.flip(ops.view(x_u, p["unl"]["geo2"], p["unl"].get("jitter2"), policy),
                            p["flip"])
        n_l, n_u = img_l.shape[0], img_u.shape[0]
        leaves = [w[k].requires_grad_(True) for k in names]
        with ops.precision(kind, device):
            logits = ops.unet_logits(torch.cat([img_l, img_u, img_u_tf]), w)
            sup = ops.masked_ce(logits[:n_l], lab_l, ncls)
            with torch.no_grad():
                t_logits = ops.flip(ops.unet_logits(img_u, {**w, **teacher}), p["flip"])
            reg = float(mt["weight"]) * ops.prob_mse(logits[n_l + n_u:], t_logits)
            grads = torch.autograd.grad(sup + reg, leaves)
        grads = dict(zip(names, grads))
        for k in names:
            w[k] = w[k].detach()
        out["losses"].append({"sup_loss": float(sup.detach()), "reg_loss": float(reg.detach())})
        out["answers"].append(ops.dice_stats(logits[:n_l].detach().argmax(dim=1), lab_l, ncls))
        if s == 0:
            wd = float(program["Optim"]["weight_decay"])
            out["first_raw"] = {k: grads[k].cpu() for k in names}
            out["first_grad"] = {k: (grads[k] + wd * w[k]).cpu() for k in names}
        opt.step(w, grads, lr)
        alpha = ops.ema_alpha(s, float(mt["alpha"]))
        with torch.no_grad():
            for k in names:
                teacher[k] = teacher[k] * alpha + w[k] * float(np.float32(1) - np.float32(alpha))
    out["after"] = {k: w[k].cpu() for k in names}
    out["after"].update({f"teacher.{k}": teacher[k].cpu() for k in names})
    return out
