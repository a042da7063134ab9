#!/usr/bin/env python
"""Inference and full evaluation from a checkpoint: the counterpart of the
root `inference.py` (reference val-time evaluation and prediction dumping,
semi_seg/epochers/helper.py:68-98).

    python -m spcl_torch.inference Arch.checkpoint=runs/sp/pre/last.ckpt \
        Trainer.save_dir=runs/inference [Data.synthetic=true] [--device cuda]

Builds the trainer of the config (`Arch.checkpoint` warm-starts its UNet),
runs the eval-mode forward over the test loader (the val loader where there
is none) one scan a batch, and reports per-scan 3D Dice, HD95 and ASSD
(`Trainer.dump_png=true` also writes each slice's prediction as a PNG under
`<save_dir>/pred`, which needs PIL). Eval mode takes the UNet's plain path,
so no kernel of `spcl_torch.ops` runs here. `--device cpu` runs on the CPU.
"""
from pathlib import Path
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.data.augment import center_crop, center_geometric, frame_pixel_mask
from spcl_torch.entry import build_trainer
from spcl_torch.main import cli
from spcl_torch.meters import SurfaceMeter, UniversalDice
from spcl_torch.training.steps import _as_float_image
from spcl_torch.utils import config_logger, fix_all_seed

Prediction = Tuple[str, np.ndarray, np.ndarray]


@torch.no_grad()
def predictions(trainer, loader) -> Iterator[Prediction]:
    """(scan name, pred, label) per batch of `loader` (one scan a batch),
    the valid slices only, as int64 [n, H, W] host arrays: the val transform
    (center crop of the original extent, or the resize of the val policy,
    on the eval canvas `_eval_out_size()`), the eval-mode forward and the
    argmax over the classes. Under a shortest-side val resize the frame's
    padding pixels are predicted as class 0, as `inference.py:56-61` does."""
    model, device = trainer.model, trainer._device
    policy = trainer.val_policy
    out_size = trainer._eval_out_size()
    shortest_side = isinstance(policy.resize, int)
    sampler = loader.sampler
    model.eval()
    for i, idx in enumerate(sampler):
        batch = loader.dataset.batch(idx)
        image = _as_float_image(torch.from_numpy(batch["image"]).to(device))
        sizes = torch.from_numpy(batch["size"]).to(device)
        img, lab = center_crop(image, torch.from_numpy(batch["label"]).to(device).long(),
                               trainer._crop, sizes=sizes, policy=policy, out_size=out_size)
        pred = model(img)["logits"].argmax(dim=1)
        if shortest_side:
            geo = center_geometric(img.shape[0], policy, image.shape[-1], sizes, out_size,
                                   device=device)
            pred = pred * frame_pixel_mask(geo, out_size).to(pred.dtype)
        keep = batch["valid"].astype(bool)
        yield sampler.scan_of_batch(i), pred.cpu().numpy()[keep], lab.cpu().numpy()[keep]


def score(preds: Iterable[Prediction], num_classes: int) -> Dict[str, float]:
    """Per-scan Dice, HD95 and ASSD over the foreground classes, merged."""
    axes = list(range(1, num_classes))
    dice = UniversalDice(num_classes, report_axises=axes)
    hd95 = SurfaceMeter(num_classes, report_axises=axes, metername="hausdorff95")
    assd = SurfaceMeter(num_classes, report_axises=axes, metername="average_surface")
    for scan, pred, lab in preds:
        dice.add_labels(pred, lab, group_name=scan)
        hd95.add(pred, lab, group_name=scan)
        assd.add(pred, lab, group_name=scan)
    return {**dice.summary(), **hd95.summary(), **assd.summary()}


def _dump_png(preds: Iterable[Prediction], pred_dir: Path) -> Iterator[Prediction]:
    from PIL import Image  # optional: only PNG dumps need it

    pred_dir.mkdir(parents=True, exist_ok=True)
    for scan, pred, lab in preds:
        for k, p in enumerate(pred):
            Image.fromarray(p.astype(np.uint8)).save(pred_dir / f"{scan}_{k:03d}.png")
        yield scan, pred, lab


def run_inference(config, save_dir: str, dump_png: bool = False, device="cuda"):
    """Build and init the config's trainer (warm start from `Arch.checkpoint`),
    then evaluate its test (else val) loader; returns the merged report."""
    trainer = build_trainer(config, save_dir=save_dir, device=device)
    trainer.init()
    loader = trainer._test_loader or trainer._val_loader
    preds = predictions(trainer, loader)
    if dump_png:
        preds = _dump_png(preds, Path(save_dir) / "pred")
    report = score(preds, trainer.model.num_classes)
    print({k: round(float(v), 4) for k, v in report.items()})
    return report


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"), strict=False).parse_args(argv)
    config = cm.merged_config
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/inference")
    config_logger(save_dir)
    fix_all_seed(int(config.get("RandomSeed", 10)))
    return run_inference(config, save_dir,
                         dump_png=bool(config.get("Trainer", {}).get("dump_png", False)),
                         device=device)


if __name__ == "__main__":
    cli(main)
