"""Command-line tools of the port, run as `python -m spcl_torch.scripts.<name>`:
`export_model` and `serve` (serving), `pack_dataset` (PNG trees and archives
into packed .npz datasets), `generate_jobs` (experiment grids as
`python -m spcl_torch.main*` lines) and `full_schedule` (the paper's whole
pretrain + fine-tune schedule on synthetic data)."""
