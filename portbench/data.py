"""The benchmark's own data and weights, made from `--seed`.

Data: ACDC-shaped slices, as the configuration's `data` block sizes them:
`patients` x `cycles` training scans named patientXXX_YY (YY the cardiac
cycle), of 13-16 slices each (`slices_per_scan`, the same counts for every
seed, in another order), and
`test_patients` x `cycles` test scans. A slice is a uint8 canvas of smooth
random structure plus noise; its label map holds `num_classes` classes cut
from a second smooth field. Both are made on the device in bulk and held on
the host as the packed arrays the program's datasets take.

Weights: every parameter of the program's model and heads from one draw of
normal numbers on the device: convolutions N(0, 2 / fan_in), linear maps
N(0, 1 / fan_in), BatchNorm scales 1 + N(0, 0.1^2), every bias N(0, 0.1^2).
The same values go to the program and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def _smooth(gen: torch.Generator, n: int, cells: int, size: int, device) -> torch.Tensor:
    """[n, size, size] float fields: N(0, 1) on a cells x cells grid,
    bilinearly upsampled."""
    low = torch.randn((n, 1, cells, cells), generator=gen, device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)[:, 0]


def scan_layout(data: Dict, seed: int) -> Tuple[List[str], List[str]]:
    """(train slice stems, test slice stems): scans patient001_00 ... in
    order. The slice counts cycle through `slices_per_scan`'s range and the
    seed only shuffles them among the scans, so that every seed holds the
    same number of slices."""
    rng = np.random.default_rng(int(seed))
    lo, hi = data["slices_per_scan"]
    stems = []
    for first, patients in ((1, data["patients"]), (data["patients"] + 1, data["test_patients"])):
        scans = patients * data["cycles"]
        counts = rng.permutation([lo + i % (hi - lo + 1) for i in range(scans)])
        out = []
        for k in range(scans):
            p, c = first + k // data["cycles"], k % data["cycles"]
            out.extend(f"patient{p:03d}_{c:02d}_{s:02d}" for s in range(int(counts[k])))
        stems.append(out)
    return stems[0], stems[1]


def make_arrays(data: Dict, n: int, seed: int, device, block: int = 512):
    """(images, labels) uint8 [n, canvas, canvas] on the host."""
    gen = _generator(seed, device)
    size = int(data["canvas"])
    images = np.empty((n, size, size), np.uint8)
    labels = np.empty((n, size, size), np.uint8)
    edges = torch.tensor([0.4, 0.9, 1.4], device=device)
    for lo in range(0, n, block):
        m = min(block, n - lo)
        body = _smooth(gen, m, 8, size, device) + 0.25 * torch.randn(
            (m, size, size), generator=gen, device=device)
        img = torch.sigmoid(body) * 255.0
        lab = torch.bucketize(_smooth(gen, m, 6, size, device), edges)
        images[lo:lo + m] = img.round().to(torch.uint8).cpu().numpy()
        lab = lab.clamp(max=int(data["num_classes"]) - 1)
        labels[lo:lo + m] = lab.to(torch.uint8).cpu().numpy()
    return images, labels


def make_datasets(data: Dict, seed: int, device):
    """The (train, test) `SliceDataset`s of the configuration's data block."""
    from spcl_torch.data import SliceDataset
    train_stems, test_stems = scan_layout(data, seed)
    images, labels = make_arrays(data, len(train_stems) + len(test_stems), seed, device)
    n = len(train_stems)
    return (SliceDataset(name=data["name"], images=images[:n], labels=labels[:n],
                         filenames=train_stems),
            SliceDataset(name=data["name"], images=images[n:], labels=labels[n:],
                         filenames=test_stems))


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for (name, shape) specs, in one draw."""
    gen = _generator(seed + 1, device)
    sizes = [int(np.prod(shape)) for _, shape in specs]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, offset = {}, 0
    for (name, shape), size in zip(specs, sizes):
        z = flat[offset:offset + size].view(shape)
        offset += size
        if len(shape) == 4:
            out[name] = z * float(np.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
        elif len(shape) == 2:
            out[name] = z * float(np.sqrt(1.0 / shape[1]))
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out
