"""The plain reference of the contrastive pretrain step with Swin-Unet's
encoder in place of the UNet's: two augmented views of each slice, view 2
flipped; the encoder (`reference/swin_unet.py`) to the hook's stage in
train mode; view 1's features flipped into view 2's frame; the projection
head; self-paced SupCon on the partition labels times the hook's weight;
the backward; RAdam with L2 decay over the encoder stages up to the hook's
and the head. The building blocks are `reference/ops.py`'s.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import ops, swin_unet


def loss_and_grads(w: Dict, names: List[str], x, labels, feed_params: Dict, policy: Dict,
                   program: Dict, gamma: float):
    sp = program["SPInfonceParams"]
    until = sp["feature_names"]
    aug, fp = feed_params["aug"], feed_params["flip"]
    v1 = ops.view(x, aug["geo1"], aug["jitter1"], policy)
    v2 = ops.flip(ops.view(x, aug["geo2"], aug["jitter2"], policy), fp)
    n = x.shape[0]
    f = swin_unet.forward(torch.cat([v1, v2]), w, swin_unet.arch(program), until)[until]
    z = ops.head(torch.cat([ops.flip(f[:n], fp), f[n:]]), w)
    loss = float(sp["weights"]) * ops.self_paced_supcon(
        z[:n], z[n:], labels, gamma, float(sp["temperature"]), hard=sp["mode"] == "hard")
    grads = torch.autograd.grad(loss, [w[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def follow(inputs: Dict, feeds: List[Dict], config: Dict, program: Dict, epoch: int,
           kind: str, device) -> Dict:
    """The reference's run of the checked steps from the benchmark's weights:
    {"losses": [{"reg_loss"}], "first_grad": {leaf: gradient + decay},
    "first_raw": {leaf: loss gradient}, "after": {leaf: value}}."""
    if int(program["Trainer"].get("grad_cache") or 0) > 1:
        raise NotImplementedError("the Swin-Unet reference follows the monolithic step")
    policy = config["augment"]["pretrain"]
    until = program["SPInfonceParams"]["feature_names"]
    stages = swin_unet.ENCODER[:swin_unet.ENCODER.index(until) + 1]
    names = [k for k in inputs["weights"]
             if k.startswith("head.") or swin_unet.stage_of(k) in stages]
    w = {k: v.to(device).clone() for k, v in inputs["weights"].items()}
    opt = ops.RAdam(names, float(program["Optim"]["weight_decay"]))
    lr, gamma = ops.epoch_lr(program, epoch), ops.epoch_gamma(program, epoch)
    wd = float(program["Optim"]["weight_decay"])
    out = {"losses": []}
    for s, feed in enumerate(feeds):
        rows = feed["rows"][0]
        x = ops.gather_images(inputs["images"], rows, device)
        labels = torch.as_tensor(inputs["partitions"][rows], device=device)
        for k in names:
            w[k].requires_grad_(True)
        with ops.precision(kind, device):
            loss, grads = loss_and_grads(w, names, x, labels, feed["params"], policy, program,
                                         gamma)
        for k in names:
            w[k] = w[k].detach()
        out["losses"].append({"reg_loss": float(loss)})
        if s == 0:
            out["first_raw"] = {k: grads[k].detach().cpu() for k in names}
            out["first_grad"] = {k: (grads[k] + wd * w[k]).detach().cpu() for k in names}
        opt.step(w, grads, lr)
    out["after"] = {k: w[k].cpu() for k in names}
    return out
