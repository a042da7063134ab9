#!/usr/bin/env python
"""Export a checkpoint into a serving artifact (spcl_torch/serving.py).

The artifact is a `torch.export` program with the weights in it, stored on
the CPU: a server runs it with torch and numpy alone, without spcl_torch's
model code. The batch dimension is symbolic by default (one artifact, any
request size). The artifact fixes no device: `load_artifact` moves it to the
device it is asked for, so there is no --platforms option; --device only
says where the verification runs.

Usage:
    python -m spcl_torch.scripts.export_model runs/sp/pre/last.ckpt model.spclt
    python -m spcl_torch.scripts.export_model last.ckpt m.spclt --size 224 \\
        --config Arch.max_channel=128 Arch.dtype=bfloat16 --batch 16 --device cpu

`--config` takes the repo's dotted-CLI grammar (Arch.num_classes=4 ...) and
is merged over config/base.yaml (needs pyyaml), so the model is built the way
the training entry points build it (entry/common.py::build_model_from_config).
Verification (unless --no-verify): the artifact is reloaded on --device and
its logits are held against the live eval-mode module's on random input on
the same device, within 1e-4 (float32; TF32 off) or 2^-7 x max|logits|
(Arch.dtype bfloat16: one bf16 rounding of the largest logit).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.serving import export_from_checkpoint, load_artifact

F32_TOL = 1e-4
BF16_REL_TOL = 2.0 ** -7


def verify(checkpoint: str, artifact: str, config, size: int, batch: int, device) -> float:
    """max |served - live| logits on random input; raises beyond the tolerance."""
    from spcl_torch.entry.common import build_model_from_config
    from spcl_torch.training.checkpoint import load_model_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served = load_artifact(artifact, device)
    model = build_model_from_config(config)
    model.load_state_dict(load_model_state_dict(checkpoint), strict=False)
    model.to(device).eval()
    x = np.random.default_rng(0).random((batch, size, size, model.input_dim), dtype=np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x).to(device).permute(0, 3, 1, 2))["logits"]
        ref = ref.permute(0, 2, 3, 1)
        err = float((served(x)["logits"] - ref).abs().max())
    tol = F32_TOL if model.dtype == torch.float32 else BF16_REL_TOL * float(ref.abs().max())
    if not err <= tol:
        raise SystemExit(f"artifact logits drift {err} from the live module (tolerance {tol})")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="trainer checkpoint or warm start (a '_model' state_dict)")
    ap.add_argument("out", help="output artifact path (.spclt)")
    ap.add_argument("--size", type=int, default=224,
                    help="input H=W after the host-side val crop (default 224)")
    ap.add_argument("--batch", type=int, default=0,
                    help="pin the batch dim (0 = symbolic, default)")
    ap.add_argument("--device", default="cuda",
                    help="where the verification runs (the artifact is device-neutral)")
    ap.add_argument("--config", nargs="*", default=[],
                    help="dotted config overrides (Arch.max_channel=128 ...)")
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args(argv)

    config = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                           strict=False).parse_args(list(args.config)).merged_config
    meta = export_from_checkpoint(args.checkpoint, args.out, config=config,
                                  height=args.size, width=args.size,
                                  batch_size=args.batch or None)
    size = Path(args.out).stat().st_size
    print(f"wrote {args.out}: {size / 1e6:.1f} MB, input {meta['input_shape']} "
          f"{meta['input_dtype']}, dtype {meta['dtype']}")
    if not args.no_verify:
        err = verify(args.checkpoint, args.out, config, args.size, args.batch or 2,
                     torch.device(args.device))
        print(f"verified on {args.device}: served logits match the live module "
              f"(max abs {err:.2e})")
    return meta


if __name__ == "__main__":
    main()
