#!/usr/bin/env python
"""Pack a reference-layout PNG dataset into the .npz files the entries load:
the counterpart of `scripts/pack_dataset.py`.

The reference trains straight off folder-of-PNG trees, decoding every slice
in DataLoader workers each step (contrastyou/data/dataset/base.py:59-227).
The port pays the decode once: run this on a downloaded / unzipped reference
dataset directory, then point the entries at the output:

    python -m spcl_torch.scripts.pack_dataset --root .data/ACDC_contrast \
        --name acdc --out .data/packed
    python -m spcl_torch.main Trainer.name=ft Data.name=acdc Data.root=.data/packed ...

Ingestion (spcl_torch/data/ioutils.py): instead of a pre-extracted --root
    --archive ACDC-all.zip      a local distribution archive (md5-checkable
                                with --md5); extracted next to itself
    --download .data            fetch the reference's hosted archive into
                                .data/ and extract (networked hosts only)
and the script packs from the extracted dataset folder.

Expected input layout (reference _ioutils.py unzip result):
    <root>/train/img/*.png   <root>/train/gt/*.png
    <root>/val/img/*.png     <root>/val/gt/*.png
mmWHS multi-modal: pass --image-folders img t2 (one channel per folder).
Decoding the PNGs needs PIL.

Original slice extents are recorded per slice (SliceDataset.sizes) so the
on-device Resize policies (prostate/spleen) reproduce the reference
geometry; pick --canvas at least the largest slice dimension to avoid any
cropping at pack time.
"""
import argparse
from pathlib import Path

from spcl_torch.constants import DATASET_SPECS, DOWNLOAD_SPECS
from spcl_torch.data.ioutils import check_integrity, extract_archive, prepare_dataset
from spcl_torch.data.packing import pack_png_folder


def resolve_root(args) -> str:
    """--root | --archive | --download -> the dataset dir with train/ val/."""
    if args.root:
        return args.root
    if args.archive:
        archive = Path(args.archive)
        if args.md5 and not check_integrity(archive, args.md5):
            raise SystemExit(f"{archive} failed the md5 check ({args.md5})")
        out = extract_archive(archive, archive.parent)
        folder = out / DOWNLOAD_SPECS[args.name]["folder_name"]
        if not folder.is_dir():
            raise SystemExit(f"{archive.name} did not contain "
                             f"{folder.name}/ (see DOWNLOAD_SPECS)")
        return str(folder)
    return str(prepare_dataset(args.name, args.download, md5=args.md5))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--root", help="pre-extracted dataset dir with train/ and val/")
    src.add_argument("--archive", help="local distribution archive (zip/tar) to extract")
    src.add_argument("--download", metavar="DIR",
                     help="fetch + extract the hosted archive into DIR")
    ap.add_argument("--md5", default=None,
                    help="pin the archive md5 (with --archive/--download)")
    ap.add_argument("--name", required=True, choices=sorted(DATASET_SPECS),
                    help="dataset key (drives scan regex / partition rules)")
    ap.add_argument("--out", required=True, help="output directory for the .npz files")
    ap.add_argument("--canvas", type=int, default=256,
                    help="square canvas size; slices are centered, zero-padded "
                         "(>= largest slice dim to avoid cropping)")
    ap.add_argument("--modes", nargs="+", default=["train", "val"])
    ap.add_argument("--image-folders", nargs="+", default=["img"],
                    help=">1 folder packs a multi-modal dataset (mmWHS)")
    args = ap.parse_args(argv)

    root = resolve_root(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for mode in args.modes:
        path = out / f"{args.name}_{mode}.npz"
        ds = pack_png_folder(root, args.name, mode=mode, canvas=args.canvas,
                             save_path=str(path),
                             image_folders=tuple(args.image_folders))
        print(f"{mode}: {len(ds)} slices, {len(ds.unique_scans)} scans, "
              f"canvas {args.canvas} -> {path} "
              f"({path.stat().st_size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
