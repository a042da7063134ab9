"""Dataset splits and loader creation.

Capability parity with reference semi_seg/data/creator.py:25-161 and
semi_seg/trainers/_helper.py:30-74 (the contrastive loader):
- labeled/unlabeled split by predefined scan lists or a seeded random
  scan-level split;
- infinite labeled/unlabeled loaders;
- val/test split of the test set (0.35, or 0.45 for mmWHS) with per-scan
  batch sampling for 3D dice;
- contrastive loader: the FULL train set under ContrastBatchSampler (acdc)
  or an infinite sampler with batch = scan_sample_num * partition_num.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .dataset import SliceDataset, extract_sub_dataset_based_on_scan_names
from .loader import HostLoader
from .samplers import (ContrastBatchSampler, InfiniteRandomSampler, ScanBatchSampler,
                       SequentialBatchSampler)
from ..constants import labeled_filenames, DATASET_SPECS
from ..utils.utils import fix_all_seed_within_context, get_logger

logger = get_logger("data.creator")


def split_dataset(dataset: SliceDataset, *ratios: float, seed: int = 1) -> List[SliceDataset]:
    """Scan-level split by cumulative ratios (reference creator.py:53-77)."""
    assert sum(ratios) <= 1, ratios
    scan_list = sorted(set(dataset.get_scan_list()))
    with fix_all_seed_within_context(seed):
        permuted = np.random.permutation(scan_list).tolist()
    cuts = []
    acc = 0.0
    for r in ratios:
        acc += r
        cuts.append(int(len(scan_list) * acc))
    bounds = [0] + cuts + [len(scan_list)]
    subs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        subs.append(extract_sub_dataset_based_on_scan_names(dataset, permuted[lo:hi]))
    assert sum(len(set(s.get_scan_list())) for s in subs) == len(scan_list)
    return subs


def split_dataset_with_predefined_filenames(dataset: SliceDataset, data_name: str,
                                            labeled_scan_num: int) -> List[SliceDataset]:
    """Reference creator.py:36-50: fixed labeled scan lists per dataset."""
    if data_name not in labeled_filenames:
        raise KeyError(data_name)
    table = labeled_filenames[data_name]
    if labeled_scan_num not in table:
        raise ValueError(f"{labeled_scan_num} not in predefined lists "
                         f"({sorted(table)}) for {data_name}")
    labeled_scans = table[labeled_scan_num]
    unlabeled_scans = sorted(set(dataset.get_scan_list()) - set(labeled_scans))
    return [extract_sub_dataset_based_on_scan_names(dataset, labeled_scans),
            extract_sub_dataset_based_on_scan_names(dataset, unlabeled_scans)]


def get_data(*, tra_set: SliceDataset, test_set: SliceDataset,
             labeled_scan_num: int, labeled_batch_size: int = 5,
             unlabeled_batch_size: int = 5, pretrain: bool = False,
             load_predefined_list: bool = True, seed: int = 1,
             pad_eval_to: Optional[int] = None,
             group_test: Optional[bool] = None
             ) -> Tuple[HostLoader, HostLoader, HostLoader, HostLoader]:
    """Returns (labeled_loader, unlabeled_loader, val_loader, test_loader).

    Mirrors reference get_data (creator.py:154-161): infinite train loaders;
    eval loaders batch per scan. `pad_eval_to` pads eval batches to one
    static shape (defaults to the longest scan), as `spcl_tpu` does.
    """
    train_scan_num = len(tra_set.get_scan_list())
    if labeled_scan_num > train_scan_num:
        raise RuntimeError(f"labeled_scan_num {labeled_scan_num} > {train_scan_num}")

    if pretrain:
        label_set, unlabeled_set = split_dataset(tra_set, 0.5, seed=seed)[:2]
    elif load_predefined_list and labeled_scan_num < train_scan_num and tra_set.name in labeled_filenames:
        label_set, unlabeled_set = split_dataset_with_predefined_filenames(
            tra_set, tra_set.name, labeled_scan_num)
    else:
        ratio = labeled_scan_num / train_scan_num
        if ratio >= 1.0:
            label_set, unlabeled_set = tra_set, tra_set
        else:
            label_set, unlabeled_set = split_dataset(tra_set, ratio, seed=seed)[:2]

    if len(label_set.get_scan_list()) == 0:
        raise RuntimeError("void labeled dataset, split dataset error")
    logger.info("labeled scans: %s", ",".join(sorted(set(label_set.get_scan_list()))))

    labeled_loader = HostLoader(label_set, InfiniteRandomSampler(
        label_set, batch_size=labeled_batch_size, seed=seed))
    unlabeled_loader = HostLoader(unlabeled_set, InfiniteRandomSampler(
        unlabeled_set, batch_size=unlabeled_batch_size, seed=seed + 1))

    # val/test split of the test set (reference create_val_loader)
    ratio = 0.45 if test_set.name in ("mmwhsct", "mmwhsmr") else 0.35
    val_set, final_test_set = split_dataset(test_set, ratio, seed=seed)[:2]

    # reference creator.py:125-127: no per-scan grouping for these datasets
    if group_test is None:
        group_test = test_set.name not in ("spleen", "mmwhsct", "mmwhsmr", "prostate_md")

    def eval_loader(ds: SliceDataset) -> HostLoader:
        if not group_test:
            return HostLoader(ds, SequentialBatchSampler(ds, batch_size=4))
        pad = pad_eval_to
        if pad is None:
            pad = max(len(v) for v in ds.scan_to_indices().values())
        return HostLoader(ds, ScanBatchSampler(ds, shuffle=False, pad_to=pad))

    return labeled_loader, unlabeled_loader, eval_loader(val_set), eval_loader(final_test_set)


def create_contrastive_loader(tra_set: SliceDataset, *, scan_sample_num: int = 10,
                              partition_sample_num: int = 1, seed: int = 0,
                              use_contrast_sampler: bool = True) -> HostLoader:
    """Reference _helper.py:30-74: the FULL train set, ContrastBatchSampler for
    acdc-style partition alignment, otherwise an infinite sampler with
    batch = scan_sample_num * partition_num * partition_sample_num."""
    spec = DATASET_SPECS[tra_set.name]
    if use_contrast_sampler:
        sampler = ContrastBatchSampler(tra_set, scan_sample_num=scan_sample_num,
                                       partition_sample_num=partition_sample_num, seed=seed)
    else:
        bs = scan_sample_num * spec["partition_num"] * partition_sample_num
        sampler = InfiniteRandomSampler(tra_set, batch_size=bs, seed=seed)
    return HostLoader(tra_set, sampler)
