"""Subprocess worker of tests/test_torch_multihost.py: NOT a test module, and
without jax. The port's counterpart of tests/multihost_worker.py.

    python tests/torch_multihost_worker.py --nprocs 2 --outdir DIR   # one rank
    python tests/torch_multihost_worker.py --nprocs 1 --outdir DIR   # alone

With `--nprocs 2` the process is one rank of a run started by hand: it joins
through `initialize_distributed` from SPCL_COORDINATOR / SPCL_NUM_PROCESSES /
SPCL_PROCESS_ID and SPCL_LOCAL_RANK / SPCL_LOCAL_WORLD_SIZE, which its
starter sets (no `spawn_local`, no `run_ranks`). With `--nprocs 1` it runs
alone, the oracle. Either way it then trains, on the CPU under
`Trainer.mesh: auto`, the three runs of spcl_tpu's worker on the synthetic
acdc fixture (canvas 48, crop 32, 10 + 3 scans, 4 labeled, UNet-32): a
`pretrain_encoder` run of 2 epochs x 4 batches with InfoNCE on Conv5 over
partitions at T=0.07, a `finetune` run with eval, and the same fine-tune with
`device_data: false`; and prints one JSON line with what the test compares:
besides the losses and dice, each run's move of every tensor the optimizer
holds (`moves`), so that a wrong reduction of the gradients shows in the
weights, not only in losses that barely change at this learning rate.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.modules.setdefault("tensorflow", None)  # tensorboard's own stub: ~10 s less a process

# config/base.yaml's optimizer at tests/torch_parallel_workers.py's rate. Not
# spcl_tpu's worker's adam 1e-3: there one process alone moves its fine-tune
# losses by 5e-5 within 8 steps when only its thread count changes (float32
# summation order through Adam's first, sign-like updates), so no run of
# ranks could be held to one process at 1e-5
OPTIM = {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5}
PROJECTIONS = 4


def moves(trainer, start):
    """Per tensor of the optimizer: its move over the run (now - `start`) as
    its L2 norm and PROJECTIONS projections on fixed Gaussian directions
    (seeded by the tensor's index), in float64. Two runs' rows differ by
    about |move_a - move_b| per row: the moves' distance without printing
    them."""
    import torch
    params = [p for g in trainer._optimizer.param_groups for p in g["params"]]
    out = []
    for i, (p, p0) in enumerate(zip(params, start)):
        d = (p.detach() - p0).double().reshape(-1)
        dirs = torch.randn(PROJECTIONS, d.numel(), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(i))
        out.append([float(d.norm())] + (dirs @ d).tolist())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--outdir", required=True)
    args = ap.parse_args()

    import torch
    torch.set_num_threads(1)
    from spcl_torch.entry import build_trainer
    from spcl_torch.parallel import mesh
    from spcl_torch.utils import fix_all_seed

    if args.nprocs > 1:
        mesh.initialize_distributed(device="cpu", timeout_s=120.0)
        assert mesh.world_size() == args.nprocs, mesh.world_size()
    pid = mesh.rank()

    data = {"name": "acdc", "synthetic": True, "canvas": 48, "crop": 32,
            "synthetic_scans": 10, "synthetic_test_scans": 3, "labeled_scan_num": 4}
    arch = {"input_dim": 1, "num_classes": 4, "max_channel": 32, "dtype": "float32"}
    base = Path(args.outdir) / f"p{pid}"

    def run(name, save_dir, **blocks):
        trainer_cfg = {"name": name, "max_epoch": 2, "num_batches": 4, "mesh": "auto",
                       "save_dir": str(save_dir)}
        trainer_cfg.update(blocks.pop("Trainer", {}))
        config = {"RandomSeed": 7, "Arch": arch, "Data": dict(data),
                  "Optim": OPTIM, "Trainer": trainer_cfg, **blocks}
        fix_all_seed(7)
        trainer = build_trainer(config, save_dir=str(save_dir), device="cpu")
        trainer.init()
        start = [p.detach().clone() for g in trainer._optimizer.param_groups
                 for p in g["params"]]
        best = float(trainer.start_training())
        trainer.moves = moves(trainer, start)
        return trainer, best

    pre, _ = run("pretrain_encoder", base / "pre",
                 InfonceParams={"feature_names": "Conv5", "weights": 1.0,
                                "contrast_ons": "partition", "temperature": 0.07},
                 ContrastiveLoaderParams={"scan_sample_num": 8, "partition_sample_num": 1})
    ft, best = run("finetune", base / "ft", LabeledLoader={"batch_size": 8})
    # host batches through `device_prefetch` (device_data false): the eval
    # fetch of a rank's rows must still gather every rank's
    stream, best_stream = run("finetune", base / "ft_stream",
                              LabeledLoader={"batch_size": 8}, Trainer={"device_data": False})

    print(json.dumps({
        "pid": pid,
        "world": mesh.world_size(),
        "n_shards": [pre.n_shards, ft.n_shards, stream.n_shards],
        "is_master": bool(pre._is_master),
        "pre_loss": pre.step_metrics[-1]["reg_loss"],
        "pre_losses": [m["reg_loss"] for m in pre.step_metrics],
        "ft_losses": [m["sup_loss"] for m in ft.step_metrics],
        "best_dice": best,
        "best_dice_stream": best_stream,
        "moves": {"pre": pre.moves, "ft": ft.moves, "ft_stream": stream.moves},
        "pre_ckpt": (base / "pre" / "last.ckpt").exists(),
        "ft_best_ckpt": (base / "ft" / "best.ckpt").exists(),
        "csv": (base / "ft" / "storage.csv").exists(),
    }), flush=True)
    mesh.shutdown()


if __name__ == "__main__":
    main()
