"""The plain reference of the contrastive pretrain step: two augmented views
of each slice, view 2 flipped; the UNet encoder to the hook's stage in
train mode; view 1's features flipped into view 2's frame; the projection
head; self-paced SupCon on the partition labels times the hook's weight;
the backward; RAdam with L2 decay over the encoder stages and the head.

With `Trainer.grad_cache: C` the batch is cut into C chunks, each chunk's
two views normalised with their own BatchNorm statistics (the gradient
cache's definition); the gradient is that of the whole loss, computed
chunk by chunk: the embeddings of every chunk without autograd, the loss's
gradient at the embeddings, then each chunk again with autograd, pulled
back from its part of that gradient.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import ops


def _embed(w, x, feed_params: Dict, lo: int, hi: int, policy: Dict, until: str):
    """(z1, z2) of rows [lo, hi) of the batch."""
    aug, fp = feed_params["aug"], feed_params["flip"]
    cut = lambda tree: {k: v[lo:hi] for k, v in tree.items()}  # noqa: E731
    x = x[lo:hi]
    v1 = ops.view(x, cut(aug["geo1"]), [j[lo:hi] for j in aug["jitter1"]], policy)
    v2 = ops.view(x, cut(aug["geo2"]), [j[lo:hi] for j in aug["jitter2"]], policy)
    v2 = ops.flip(v2, cut(fp))
    m = hi - lo
    f = ops.encoder(torch.cat([v1, v2]), w, until)[until]
    z = ops.head(torch.cat([ops.flip(f[:m], cut(fp)), f[m:]]), w)
    return z[:m], z[m:]


def loss_and_grads(w: Dict, names: List[str], x, labels, feed_params: Dict, policy: Dict,
                   program: Dict, gamma: float):
    sp = program["SPInfonceParams"]
    until = sp["feature_names"]
    chunks = max(int(program["Trainer"].get("grad_cache") or 0), 1)
    n = x.shape[0]
    m = n // chunks

    def loss_of(z1, z2):
        return float(sp["weights"]) * ops.self_paced_supcon(
            z1, z2, labels, gamma, float(sp["temperature"]), hard=sp["mode"] == "hard")

    leaves = [w[k] for k in names]
    if chunks == 1:
        loss = loss_of(*_embed(w, x, feed_params, 0, n, policy, until))
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))
    with torch.no_grad():
        parts = [_embed(w, x, feed_params, c * m, (c + 1) * m, policy, until)
                 for c in range(chunks)]
    z1 = torch.cat([p[0] for p in parts]).requires_grad_(True)
    z2 = torch.cat([p[1] for p in parts]).requires_grad_(True)
    loss = loss_of(z1, z2)
    d1, d2 = torch.autograd.grad(loss, [z1, z2])
    total = [torch.zeros_like(t) for t in leaves]
    for c in range(chunks):
        c1, c2 = _embed(w, x, feed_params, c * m, (c + 1) * m, policy, until)
        g = torch.autograd.grad([c1, c2], leaves, [d1[c * m:(c + 1) * m], d2[c * m:(c + 1) * m]],
                                allow_unused=True)
        total = [t if gi is None else t + gi for t, gi in zip(total, g)]
    return loss.detach(), dict(zip(names, total))


def follow(inputs: Dict, feeds: List[Dict], config: Dict, program: Dict, epoch: int,
           kind: str, device) -> Dict:
    """The reference's run of the checked steps from the benchmark's weights:
    {"losses": [{"reg_loss"}], "first_grad": {leaf: gradient + decay},
    "first_raw": {leaf: loss gradient}, "after": {leaf: value}}."""
    policy = config["augment"]["pretrain"]
    until = program["SPInfonceParams"]["feature_names"]
    stages = ops.ENCODER[:ops.ENCODER.index(until) + 1]
    names = ops.leaf_names(inputs["weights"], stages, head_too=True)
    w = {k: v.to(device).clone() for k, v in inputs["weights"].items()}
    opt = ops.RAdam(names, float(program["Optim"]["weight_decay"]))
    lr, gamma = ops.epoch_lr(program, epoch), ops.epoch_gamma(program, epoch)
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
            wd = float(program["Optim"]["weight_decay"])
            out["first_raw"] = {k: grads[k].detach().cpu() for k in names}
            out["first_grad"] = {k: (grads[k] + wd * w[k]).detach().cpu() for k in names}
        opt.step(w, grads, lr)
    out["after"] = {k: w[k].cpu() for k in names}
    return out
