from .dataset import (SliceDataset, compute_partition,
                      extract_sub_dataset_based_on_scan_names, scan_name_from_stem)
from .samplers import (ContrastBatchSampler, InfiniteRandomSampler,
                       LimitedIterationSampler, ScanBatchSampler, SequentialBatchSampler)
from .device_store import DeviceStore, gather_from
from .loader import HostLoader, device_prefetch
from .packing import (corrupt_meta_labels, load_packed, pack_png_folder, save_packed,
                      synthetic_dataset, synthetic_dataset_hard)
from .creator import (create_contrastive_loader, get_data, split_dataset,
                      split_dataset_with_predefined_filenames)

__all__ = [
    "SliceDataset", "compute_partition", "extract_sub_dataset_based_on_scan_names",
    "scan_name_from_stem", "ContrastBatchSampler", "InfiniteRandomSampler",
    "LimitedIterationSampler", "ScanBatchSampler", "SequentialBatchSampler",
    "DeviceStore", "gather_from", "HostLoader", "device_prefetch", "corrupt_meta_labels", "load_packed", "pack_png_folder",
    "save_packed", "synthetic_dataset", "synthetic_dataset_hard",
    "create_contrastive_loader", "get_data", "split_dataset",
    "split_dataset_with_predefined_filenames",
]
