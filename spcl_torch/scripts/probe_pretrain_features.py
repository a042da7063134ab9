#!/usr/bin/env python
"""Linear probe of the pretrained encoder's meta-label structure: the
counterpart of `scripts/probe_pretrain_features.py`.

    python -m spcl_torch.scripts.probe_pretrain_features [--device cuda]
        [--out runs/effect_study_torch]

The paper's mechanism (reference contrast_loss3.py:113-222) is that
self-paced weighting keeps contrastive pretraining useful when meta-labels
are noisy. The probe measures it directly: how linearly separable the CLEAN
anatomy level (partition) is in frozen Conv5 features after each pretrain.

For every `<out>/<arm>_s<seed>/pre/last.ckpt` of the effect study: embed all
training slices (the val policy's centre crop, eval mode, float32, the mean
of Conv5 over H and W), fit a least-squares one-hot linear classifier on the
even patients, report held-out accuracy on the odd ones. Prints one JSON
line per run, a per-arm summary and its gate against spcl_tpu's probe
(RESULTS.md:525-533), and writes the summary to `<out>/z_probe.json`.
"""
import argparse
import json
from pathlib import Path

import numpy as np

from spcl_torch.scripts import effect_study


def embed_dataset(ckpt: str, canvas: int = 64, crop: int = 48, device="cuda"):
    """(features [slices, 128], dataset): the port's UNet-128 from `ckpt`'s
    model state, to Conv5 in eval mode, over every slice of the study's
    training set (clean meta-labels), mean-pooled over H and W."""
    import torch

    from spcl_torch.data.packing import synthetic_dataset_hard
    from spcl_torch.models import UNet
    from spcl_torch.training import load_model_state_dict

    ds = synthetic_dataset_hard("acdc", num_scans=20, canvas=canvas, seed=0)
    model = UNet(input_dim=1, num_classes=4, max_channel=128)
    model.load_state_dict(load_model_state_dict(ckpt), strict=True)
    model.to(device).eval()

    off = (canvas - crop) // 2
    imgs = ds.images[:, off:off + crop, off:off + crop].astype(np.float32) / 255.0
    feats = []
    with torch.no_grad():
        for i in range(0, len(imgs), 64):
            x = torch.from_numpy(np.ascontiguousarray(imgs[i:i + 64, None])).to(device)
            acts = model(x, until="Conv5")
            feats.append(acts["Conv5"].float().mean(dim=(2, 3)).cpu().numpy())
    return np.concatenate(feats), ds


def probe_accuracy(feats: np.ndarray, ds) -> float:
    """Least-squares one-hot linear probe, split by PATIENT (no leakage)."""
    y = ds.partitions
    pats = np.asarray(ds.patient_index)
    train = pats % 2 == 0
    x = (feats - feats[train].mean(0)) / (feats[train].std(0) + 1e-6)
    x = np.concatenate([x, np.ones((len(x), 1))], 1)
    onehot = np.eye(int(y.max()) + 1)[y]
    w, *_ = np.linalg.lstsq(x[train], onehot[train], rcond=None)
    pred = (x[~train] @ w).argmax(1)
    return float((pred == y[~train]).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(effect_study.OUT),
                    help="the effect study's record folder (bf16: its bfloat16/)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    rows = {}
    for ckpt in sorted(out_dir.glob("*_s*/pre/last.ckpt")):
        run = ckpt.parent.parent.name          # e.g. sp_corrupt_s20
        arm, seed = run.rsplit("_s", 1)
        feats, ds = embed_dataset(str(ckpt), device=args.device)
        acc = probe_accuracy(feats, ds)
        print(json.dumps({"arm": arm, "seed": int(seed),
                          "z_probe_acc": round(acc, 4)}), flush=True)
        rows.setdefault(arm, []).append(acc)
    summary = {a: {"mean": round(float(np.mean(v)), 4),
                   "std": round(float(np.std(v)), 4), "n": len(v)}
               for a, v in rows.items()}
    verdict = effect_study.gate({a: (float(np.mean(v)), float(np.std(v)), len(v))
                                 for a, v in rows.items()}, effect_study.JAX_PROBE)
    print(json.dumps({"summary": summary, "gate": verdict}))
    (out_dir / "z_probe.json").write_text(json.dumps(summary, indent=1))
    return summary, verdict


if __name__ == "__main__":
    main()
