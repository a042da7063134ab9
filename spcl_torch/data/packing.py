"""Offline data packing: folder-of-PNGs -> contiguous arrays; synthetic data.

The reference reads PNG slices through PIL in DataLoader workers every step
(contrastyou/data/dataset/base.py:59-227). Here the decode is paid once:
`pack_png_folder` converts a reference-layout dataset directory
(`<root>/<train|val>/{img,gt}/*.png`) into one .npz of packed uint8 arrays +
metadata, and training streams pure array indexing. The packed `.npz` format
is the one `spcl_tpu` reads and writes, so one pack serves both packages.

`synthetic_dataset` builds an in-memory dataset with the same scan/partition
structure (random blobs + label maps) so the trainer runs without the real
(gdrive-hosted) data. With the same seed it gives the same arrays as
`spcl_tpu.data.packing.synthetic_dataset`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .dataset import SliceDataset
from ..constants import DATASET_SPECS


def _load_png(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def _fit_canvas(arr: np.ndarray, canvas: int, is_label: bool) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Center-pad to (canvas, canvas) without resampling (labels stay exact);
    crops only when the slice exceeds the canvas (pick a bigger canvas to keep
    the full extent). Returns (packed, stored (h, w)) — the stored extent
    drives the on-device Resize policies (augment.AugmentPolicy.resize)."""
    h, w = arr.shape[:2]
    out = np.zeros((canvas, canvas), dtype=arr.dtype)
    ch, cw = min(h, canvas), min(w, canvas)
    src_y, src_x = (h - ch) // 2, (w - cw) // 2
    dst_y, dst_x = (canvas - ch) // 2, (canvas - cw) // 2
    out[dst_y:dst_y + ch, dst_x:dst_x + cw] = arr[src_y:src_y + ch, src_x:src_x + cw]
    return out, (ch, cw)


def pack_png_folder(root_dir: str, name: str, mode: str = "train",
                    canvas: int = 256, save_path: Optional[str] = None,
                    image_folders=("img",)) -> SliceDataset:
    """Pack `<root>/<mode>/img/*.png` (+ `gt/`) into a SliceDataset.

    mode: "train" | "val" (reference folder layout, base.py:76-116).
    image_folders: >1 folder packs a multi-modal dataset — one channel per
    folder (reference mmWHS/multi-modal path, semi_seg/epochers/helper.py:33-36
    concatenates modalities on the channel axis).
    """
    src = Path(root_dir) / mode
    gt_dir = src / "gt"
    img_dirs = [src / f for f in image_folders]
    for d in img_dirs:
        if not d.exists():
            raise FileNotFoundError(
                f"{d} not found. Materialize the dataset first "
                f"(extract the {name!r} archive there), or use "
                f"synthetic_dataset().")
    stems = sorted(p.stem for p in img_dirs[0].glob("*.png"))
    mods, sizes = [], None
    for d in img_dirs:
        packed = [_fit_canvas(_load_png(d / f"{s}.png"), canvas, False) for s in stems]
        mods.append(np.stack([p[0] for p in packed]))
        mod_sizes = np.asarray([p[1] for p in packed], np.int32)
        if sizes is None:
            sizes = mod_sizes  # first modality defines the stored extents
        elif not np.array_equal(sizes, mod_sizes):
            bad = np.nonzero((sizes != mod_sizes).any(axis=1))[0][0]
            raise ValueError(
                f"modality {d.name!r} slice {stems[bad]!r} extent "
                f"{tuple(mod_sizes[bad])} != {tuple(sizes[bad])} from "
                f"{image_folders[0]!r}: multi-modal folders must agree on "
                f"per-slice dims (the extents drive on-device Resize geometry)")
    images = mods[0] if len(mods) == 1 else np.stack(mods, axis=-1)
    if gt_dir.exists():
        gt_packed = [_fit_canvas(_load_png(gt_dir / f"{s}.png"), canvas, True)
                     for s in stems]
        labels = np.stack([p[0] for p in gt_packed])
        gt_sizes = np.asarray([p[1] for p in gt_packed], np.int32)
        if not np.array_equal(sizes, gt_sizes):
            bad = np.nonzero((sizes != gt_sizes).any(axis=1))[0][0]
            raise ValueError(
                f"gt slice {stems[bad]!r} extent {tuple(gt_sizes[bad])} != "
                f"image extent {tuple(sizes[bad])}")
    else:
        labels = np.zeros(images.shape[:3], images.dtype)
    ds = SliceDataset(name=name, images=images.astype(np.uint8),
                      labels=labels.astype(np.uint8), filenames=stems, sizes=sizes)
    if save_path:
        save_packed(ds, save_path)
    return ds


def save_packed(ds: SliceDataset, path: str) -> None:
    np.savez_compressed(
        path, name=ds.name, images=ds.images, labels=ds.labels,
        filenames=np.asarray(ds.filenames), sizes=ds.sizes)


def load_packed(path: str) -> SliceDataset:
    z = np.load(path, allow_pickle=False)
    sizes = z["sizes"] if "sizes" in z.files else None  # pre-sizes packs
    return SliceDataset(name=str(z["name"]), images=z["images"], labels=z["labels"],
                        filenames=[str(f) for f in z["filenames"]], sizes=sizes)


def synthetic_dataset(name: str = "acdc", num_scans: int = 10,
                      slices_per_scan: Tuple[int, int] = (8, 12), canvas: int = 256,
                      seed: int = 0, mode: str = "train",
                      channels: int = 1) -> SliceDataset:
    """Random dataset with realistic scan/partition/filename structure.

    channels > 1 emulates a multi-modal dataset (stacked noisy copies)."""
    spec = DATASET_SPECS[name]
    rng = np.random.default_rng(seed + (0 if mode == "train" else 1))
    num_classes = spec["num_classes"]
    stems, imgs, labs = [], [], []
    for s in range(num_scans):
        n_slices = int(rng.integers(slices_per_scan[0], slices_per_scan[1] + 1))
        if name == "acdc":
            scan = f"patient{s:03d}_{rng.integers(0, 2):02d}"
        elif name == "prostate":
            scan = f"Case{s:02d}"
        elif name == "prostate_md":
            scan = f"prostate_{s:02d}"
        else:
            scan = f"{1000 + s}"
        # a blob whose position drifts with slice index (so partitions differ)
        yy, xx = np.mgrid[0:canvas, 0:canvas]
        cx = rng.integers(canvas // 3, 2 * canvas // 3)
        cy0 = canvas // 4
        for i in range(n_slices):
            cy = cy0 + (i * canvas // 2) // max(n_slices - 1, 1)
            r = rng.integers(canvas // 10, canvas // 6)
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
            img = (rng.normal(0.25, 0.08, (canvas, canvas)) + blob * 0.5).clip(0, 1)
            lab = np.zeros((canvas, canvas), np.uint8)
            for c in range(1, num_classes):
                rc = max(int(r * (1 - 0.25 * c)), 2)
                lab[((yy - cy) ** 2 + (xx - cx) ** 2) < rc ** 2] = c
            stems.append(f"{scan}_{i:02d}")
            if channels > 1:
                chans = [img] + [np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
                                 for _ in range(channels - 1)]
                imgs.append((np.stack(chans, axis=-1) * 255).astype(np.uint8))
            else:
                imgs.append((img * 255).astype(np.uint8))
            labs.append(lab)
    return SliceDataset(name=name, images=np.stack(imgs), labels=np.stack(labs),
                        filenames=stems)


def _ellipse(yy, xx, cy, cx, ry, rx, theta):
    """Rotated-ellipse mask."""
    ct, st = np.cos(theta), np.sin(theta)
    u = (yy - cy) * ct + (xx - cx) * st
    v = -(yy - cy) * st + (xx - cx) * ct
    return (u / ry) ** 2 + (v / rx) ** 2 < 1.0


def synthetic_dataset_hard(name: str = "acdc", num_scans: int = 10,
                           slices_per_scan: Tuple[int, int] = (8, 12),
                           canvas: int = 64, seed: int = 0,
                           mode: str = "train") -> SliceDataset:
    """A synthetic regime that does NOT saturate from scratch at low labels
    (VERDICT r4 item 2) — built so the contrastive meta-labels carry the
    missing information, mirroring why the paper's pretraining helps on ACDC:

    - The anatomy level z (== the partition meta-label) is readable from the
      global appearance: a "body" ellipse whose width tracks z.
    - The target is an ellipse whose ORIENTATION and ECCENTRICITY are smooth,
      scan-invariant functions of z (nested class rings inside, as the easy
      regime). 1-3 DISTRACTOR blobs share its intensity but have random
      shape parameters: a model must hold the z -> shape prior to tell them
      apart — exactly what contrast-on-partition pretraining teaches.
    - Heavy per-scan style variance (gain/offset, noise level, low-frequency
      bias field) and low target contrast, so a few labeled scans don't
      cover the style distribution.
    """
    spec = DATASET_SPECS[name]
    rng = np.random.default_rng(seed + (0 if mode == "train" else 100))
    num_classes = spec["num_classes"]
    stems, imgs, labs = [], [], []
    yy, xx = np.mgrid[0:canvas, 0:canvas].astype(np.float64)
    boost = 0.18
    for s in range(num_scans):
        n_slices = int(rng.integers(slices_per_scan[0], slices_per_scan[1] + 1))
        if name == "acdc":
            scan = f"patient{s:03d}_{rng.integers(0, 2):02d}"
        elif name == "prostate":
            scan = f"Case{s:02d}"
        elif name == "prostate_md":
            scan = f"prostate_{s:02d}"
        else:
            scan = f"{1000 + s}"
        # per-scan style
        gain = rng.uniform(0.7, 1.3)
        offset = rng.uniform(-0.08, 0.08)
        noise_std = rng.uniform(0.06, 0.13)
        gy, gx = rng.uniform(-0.12, 0.12, 2)          # bias-field gradient
        body_cx = rng.uniform(0.42, 0.58) * canvas
        body_cy = rng.uniform(0.42, 0.58) * canvas
        tgt_dx = rng.uniform(-0.10, 0.10)             # target offset in body, per scan
        tgt_dy = rng.uniform(-0.10, 0.10)
        for i in range(n_slices):
            z = i / max(n_slices - 1, 1)              # anatomy level in [0, 1]
            # body width tracks z -> z is readable from any slice
            body_rx = canvas * (0.24 + 0.18 * z)
            body_ry = canvas * 0.38
            body = _ellipse(yy, xx, body_cy, body_cx, body_ry, body_rx, 0.0)
            # target: shape is a scan-invariant function of z
            r = canvas * (0.15 + 0.04 * np.sin(2 * np.pi * z))
            ecc = 0.45 + 0.45 * z                     # rx = ecc * ry
            theta = (np.pi * 0.8) * z - np.pi * 0.4
            cy = body_cy + tgt_dy * canvas + (z - 0.5) * 0.25 * canvas
            cx = body_cx + tgt_dx * canvas
            target = _ellipse(yy, xx, cy, cx, r, r * ecc, theta)
            img = rng.normal(0.22, noise_std, (canvas, canvas))
            img += gy * (yy / canvas - 0.5) + gx * (xx / canvas - 0.5)
            img += body * 0.12 + target * boost
            # distractors: same intensity, random shape params, inside body
            for _ in range(int(rng.integers(1, 4))):
                dr = canvas * rng.uniform(0.08, 0.17)
                decc = rng.uniform(0.45, 0.95)
                dth = rng.uniform(-np.pi / 2, np.pi / 2)
                dcy = body_cy + rng.uniform(-0.25, 0.25) * canvas
                dcx = body_cx + rng.uniform(-0.2, 0.2) * canvas
                img += _ellipse(yy, xx, dcy, dcx, dr, dr * decc, dth) * boost
            img = np.clip(img * gain + offset, 0.0, 1.0)
            lab = np.zeros((canvas, canvas), np.uint8)
            for c in range(1, num_classes):
                frac = 1.0 - 0.25 * (c - 1)
                lab[_ellipse(yy, xx, cy, cx, r * frac, r * ecc * frac, theta)] = c
            stems.append(f"{scan}_{i:02d}")
            imgs.append((img * 255).astype(np.uint8))
            labs.append(lab)
    return SliceDataset(name=name, images=np.stack(imgs), labels=np.stack(labs),
                        filenames=stems)


def corrupt_meta_labels(ds: SliceDataset, frac: float, seed: int = 0) -> SliceDataset:
    """Randomize the contrastive meta-labels (partition + cycle) of a
    fraction of slices IN PLACE on a copy — the paper's noisy-meta-label
    regime (the reference's self-paced weighting exists to survive exactly
    this, contrast_loss3.py:113-222). Segmentation labels are untouched."""
    import copy

    assert ds.root is ds, "corrupt the ROOT dataset (before subsetting) — " \
                          "the DeviceStore packs root meta vectors"
    out = copy.copy(ds)
    rng = np.random.default_rng(seed)
    n = len(ds.filenames)
    pick = rng.random(n) < float(frac)
    parts = ds.partitions.copy()
    cycles = ds.cycles.copy()
    n_part = int(ds.partitions.max()) + 1 if n else 1
    parts[pick] = rng.integers(0, max(n_part, 1), int(pick.sum()))
    if ds.cycles.max() > 0:
        cycles[pick] = rng.integers(0, 2, int(pick.sum()))
    out.partitions = parts
    out.cycles = cycles
    out.root = out  # corrupted vectors must be what the DeviceStore packs
    return out
