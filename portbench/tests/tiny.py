"""Tiny sizes for the CPU tests: the cells' own configurations and traffic
with the UNet at max_channel 32 on 32-pixel crops of 40-pixel canvases,
and batches of a few slices. Widths are cut here only; the chip runs the
files as they are."""

CONFIG = {"data": {"canvas": 40, "slices_per_scan": [13, 13], "test_patients": 2},
          "augment": {"pretrain": {"crop": 32}, "label": {"crop": 32}},
          "program": {"Arch": {"max_channel": 32}, "Data": {"crop": 32, "canvas": 40}}}

TRAFFIC = {
    "pretrain-2n60-nhwc": {"program": {"ContrastiveLoaderParams": {"scan_sample_num": 4},
                                       "Trainer": {"num_batches": 3}}, "trace_steps": 2},
    "semi-mt-b32-pallas": {"program": {"LabeledLoader": {"batch_size": 4},
                                       "UnlabeledLoader": {"batch_size": 4},
                                       "Trainer": {"num_batches": 3}}, "trace_steps": 2},
    "pretrain-2n3840-gradcache": {"program": {
        "ContrastiveLoaderParams": {"scan_sample_num": 4, "partition_sample_num": 4},
        "Trainer": {"num_batches": 2, "grad_cache": 4}}, "trace_steps": 1},
}


def overrides(workload: str) -> dict:
    return {"config": CONFIG, "traffic": TRAFFIC[workload]}
