"""Dataset constants & reproduction hyperparameters.

Parity with reference semi_seg/__init__.py:1-88 (ratio/epoch/lr zoos,
predefined labeled scan lists) and the per-dataset regex/partition specs
scattered over contrastyou/data/dataset/*.py + semi_seg/data/dataset.py.
"""

DATASET_SPECS = {
    # scan_re: regex that extracts a scan id from a slice filename stem
    # partition semantics follow the reference exactly (see data/dataset.py)
    "acdc": dict(scan_re=r"patient\d+_\d+", partition_num=3, num_classes=4,
                 input_dim=1, has_cycle=True, partition_style="acdc"),
    "prostate": dict(scan_re=r"Case\d+", partition_num=8, num_classes=2,
                     input_dim=1, has_cycle=False, partition_style="div"),
    "prostate_md": dict(scan_re=r"prostate_\d+", partition_num=4, num_classes=3,
                        input_dim=1, has_cycle=False, partition_style="div"),
    "mmwhsct": dict(scan_re=r"\d+", partition_num=8, num_classes=5,
                    input_dim=1, has_cycle=False, partition_style="div"),
    "mmwhsmr": dict(scan_re=r"\d+", partition_num=8, num_classes=5,
                    input_dim=1, has_cycle=False, partition_style="div"),
    "spleen": dict(scan_re=r"\d+", partition_num=4, num_classes=2,
                   input_dim=1, has_cycle=False, partition_style="div"),
}

# Archive specs for the reference's distribution zips (constant table, must
# match the reference for drop-in ingestion parity: acdc.py:9-11,
# prostate.py:9-28, mmwhs.py:9-27, spleen.py:9-11). `folder_name` is the
# directory the archive extracts to; the reference ships no md5 pins
# (downloading() passes md5=None, _ioutils.py:192) — `md5` stays None here
# and callers may pin their own.
DOWNLOAD_SPECS = {
    "acdc": dict(
        download_link="https://drive.google.com/uc?id=147xICU__T23aOYkdjGSA5Hh8W1SK-y9p",
        zip_name="ACDC-all.zip", folder_name="ACDC-all", md5=None),
    "prostate": dict(
        download_link="https://drive.google.com/uc?id=1hZISuvq2OGk6MZDhZ-p5ebV0q0IXAlaf",
        zip_name="PROSTATE.zip", folder_name="PROSTATE", md5=None),
    "prostate_md": dict(
        download_link="https://drive.google.com/uc?id=1MngFjFmbO8lBHC0G6sbW7_kjjijQqSsu",
        zip_name="PROSTATE_md.zip", folder_name="PROSTATE_md", md5=None),
    "mmwhsct": dict(
        download_link="https://drive.google.com/uc?id=1oDKm6W6wQJRFCuiavDo3hzl7Prx2t0c0",
        zip_name="MMWHS.zip", folder_name="MMWHS", md5=None),
    "mmwhsmr": dict(
        download_link="https://drive.google.com/uc?id=1oDKm6W6wQJRFCuiavDo3hzl7Prx2t0c0",
        zip_name="MMWHS.zip", folder_name="MMWHS", md5=None),
    "spleen": dict(
        download_link="https://drive.google.com/uc?id=1VG14fqf6EltsR7HUs5dFvN0X7ru0w_wH",
        zip_name="Spleen.zip", folder_name="Spleen", md5=None),
}

ratio_zoo = {
    "acdc": [1, 2, 4, 174],
    "prostate": [3, 5, 7, 40],
    "prostate_md": [1, 2, 4, 17],
    "mmwhsct": [1, 2, 10],
    "mmwhsmr": [1, 2, 10],
}

pre_max_epoch_zoo = {"acdc": 80, "mmwhsct": 80, "mmwhsmr": 80, "prostate": 80}
ft_max_epoch_zoo = {"acdc": 60, "mmwhsct": 60, "mmwhsmr": 60, "prostate": 80}
num_batches_zoo = {"acdc": 200, "mmwhsct": 350, "mmwhsmr": 350, "prostate": 300}

data2class_numbers = {name: spec["num_classes"] for name, spec in DATASET_SPECS.items()}
data2input_dim = {name: spec["input_dim"] for name, spec in DATASET_SPECS.items()}

pre_lr_zooms = {"acdc": 5e-7, "prostate": 5e-7, "prostate_md": 5e-6,
                "mmwhsct": 5e-7, "mmwhsmr": 5e-7}
ft_lr_zooms = {"acdc": 2e-7, "prostate": 5e-7, "prostate_md": 5e-7,
               "spleen": 1e-6, "mmwhsct": 2e-6, "mmwhsmr": 2e-6}

labeled_filenames = {
    "acdc": {1: ["patient100_00"],
             2: ["patient027_01", "patient100_00"],
             4: ["patient027_01", "patient038_01", "patient067_01", "patient100_00"],
             8: ["patient027_01", "patient038_01", "patient067_01", "patient100_00",
                 "patient002_00", "patient004_00", "patient006_01", "patient007_00"]},
    "prostate": {3: ["Case10", "Case17", "Case45"],
                 5: ["Case00", "Case10", "Case17", "Case37", "Case45"],
                 7: ["Case00", "Case10", "Case17", "Case34", "Case37", "Case38", "Case45"]},
    "mmwhsct": {1: ["1003"], 2: ["1003", "1010"]},
}
