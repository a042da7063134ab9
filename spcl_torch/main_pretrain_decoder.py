#!/usr/bin/env python
"""Decoder pretraining on the GPU, then the fine-tune sweep: the counterpart
of `main_pretrain_decoder.py` (reference main_pretrain_decoder.py:42-76).

    python -m spcl_torch.main_pretrain_decoder [Key.Sub=value ...] \
        [--opt-path config/hooks/infonce_dense.yaml] [--device cuda]

Merges config/base.yaml + config/pretrain.yaml (+ --opt-path files + dotted
CLI overrides; needs pyyaml) and splits it into a pretrain config (`pre_`
overrides) and a fine-tune config (`ft_` overrides). Phase 1 trains the
`pretrain_decoder` trainer: the UNet from Conv5 up to the hooks' deepest
stage learns with the configured (dense, self-paced) InfoNCE hooks, the
encoder below Conv5 stays at its weights (warm-start it with
`Arch.checkpoint=<encoder pretrain>/last.ckpt`), both views share one
geometry; it writes `<save_dir>/pre/last.ckpt`. Phase 2 (`entry.val`)
fine-tunes the whole UNet from it at every labeled ratio (`Data.ratios`,
else the dataset's ratio zoo). Returns and prints {ratio: best val DSC}.
`--device cpu` runs the plain versions of the kernels. `Trainer.mesh=N` (or
`auto`) starts N local ranks as `main_pretrain_encoder.py` does; the dense
points and their SimCLR ids span the global batch. `Trainer.grad_cache` is
refused with a decoder hook, as spcl_tpu refuses it (its dense point
sampling is batch-local).
"""
import argparse
import sys
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.main_pretrain_encoder import run as run_pipeline
from spcl_torch.parallel import mesh


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "pretrain.yaml"),
                       strict=False).parse_args(argv)
    config = cm.merged_config
    return mesh.run_ranks(config.get("Trainer", {}).get("mesh", 0), run, (config, device),
                          device=device)


def run(config, device="cuda"):
    """Both phases from a merged config, in this process (one rank of the
    run under `Trainer.mesh`)."""
    return run_pipeline(config, device, until_check=None, trainer_name="pretrain_decoder")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(sys.argv[1:])
    print(main(rest, device=ns.device))
