"""spcl_torch's public surface against spcl_tpu's, read from the sources.

For every module `spcl_tpu/<path>.py` the counterpart is
`spcl_torch/<path>.py`. Every public top-level `def` / `class` of the
module, and every public name a package `__init__.py` imports, lists in
`__all__` or assigns, must be defined at top level of the counterpart: by a
`def`, a `class`, an assignment or an import of that name (a substring of
another name does not count).

Two tables hold the exceptions, each entry with its reason:
- `MOVED`: the counterpart lives under another module or name; the target
  must be defined there.
- `BY_DESIGN`: names (or whole modules) the port does without.
A name an `__init__.py` imports from a submodule follows the entry of that
submodule's name: skipped if it is by design, and if it moved, the port's
`__init__.py` must define the target name.

The packages are parsed with `ast`; neither is imported.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TPU = ROOT / "spcl_tpu"
PORT = ROOT / "spcl_torch"

# "spcl_tpu module::name" (or a whole module) -> (port module, port name or
# None for the same name, reason)
MOVED = {
    "ops/supcon_pallas.py": (
        "ops/supcon_cuda.py", None,
        "the wrappers of the Pallas SupCon kernels; the CUDA kernels' module keeps their "
        "names and signatures"),
    "experimental/packed_block_pallas.py::fused_packed_block": (
        "ops/convstage_cuda.py", "fused_conv_stage",
        "the fused small-channel stage (conv, BN, ReLU, pool; forward and backward) as "
        "hand-written CUDA kernels"),
    "experimental/packed_stage.py::PallasConvStage": (
        "experimental/packed_stage.py", "run_conv_stage",
        "`small_c_layout: pallas` runs a ConvBlock's own modules through the kernels, so "
        "checkpoints keep the plain path's keys; no module of its own"),
    "experimental/packed_stage.py::PackedConvStage": (
        "models/unet.py", "ConvBlock",
        "`small_c_layout: packed` is ConvBlock's packed path (its BatchNorm's packed mode)"),
    "experimental/packed_stage.py::packed_conv": (
        "models/packed_layout.py", "packed_conv",
        "the packed convolution's function (bf16 rounding of its nine partial sums) in NCHW"),
    "models/masking.py::stage_trainable_mask": (
        "models/masking.py", "set_trainable_stages",
        "frozen stages get requires_grad off in place of an optax mask tree (ROADMAP C8)"),
    "models/norm.py::TorchBatchNorm": (
        "models/norm.py", "CrossRankBatchNorm2d",
        "torch's BatchNorm2d has the semantics TorchBatchNorm pins on flax; the subclass adds "
        "the cross-rank statistics of an axis_name"),
    "training/checkpoint.py::load_model_params": (
        "training/checkpoint.py", "load_model_state_dict",
        "a model-only warm start from a full checkpoint, as a torch state_dict"),
}

# "spcl_tpu module::name" (or a whole module) -> reason
BY_DESIGN = {
    "utils/rng.py":
        "JAX PRNG key plumbing (KeyChain, key_from_seed); the port draws from explicit "
        "torch.Generators owned by the trainer",
    "training/state.py":
        "flax's TrainState and its constructor; state lives in nn.Modules and torch "
        "optimizers",
    "models/torch_import.py":
        "imports the reference's torch checkpoints into flax; the port's UNet has the "
        "reference's keys, and models/transplant.py is the inverse, for the tests",
    "data/warp_mxu.py":
        "the TPU's gather-free warp on the matrix unit; the port warps by gather "
        "(data/augment.py::apply_geometric)",
    "data/augment.py::mesh_warp_block":
        "the block size of warp_mxu's batching under a mesh; the port has no warp_mxu",
    "experimental/maxpool.py":
        "a measured-negative TPU experiment (custom max-pool backward), off every path",
    "experimental/packed_stage.py::pack":
        "the TPU lane layout (channels packed into 128 lanes); the port runs packed's "
        "function in NCHW (models/packed_layout.py)",
    "experimental/packed_stage.py::unpack":
        "the inverse of the TPU lane layout's pack",
    "experimental/packed_stage.py::packed_pool":
        "the 2x2 pool on the TPU lane layout; the port pools NCHW",
    "parallel/mesh.py::make_mesh":
        "GSPMD placement on a jax Mesh; the port starts ranks (parallel/mesh.py::run_ranks) "
        "over torch.distributed",
    "parallel/mesh.py::put_tree":
        "GSPMD placement of a pytree; each rank holds its own tensors",
    "parallel/mesh.py::data_sharding":
        "a GSPMD NamedSharding; each rank keeps its own rows (parallel/mesh.py::shard_rows)",
    "parallel/mesh.py::shard_batch":
        "GSPMD batch placement; each rank keeps its own rows (parallel/mesh.py::shard_rows)",
    "parallel/mesh.py::replicate":
        "GSPMD replication; ranks start from rank 0's broadcast weights "
        "(parallel/mesh.py::broadcast_tensors)",
    "parallel/contrastive.py::make_global_supcon_fn":
        "a shard_map + jit wrapper; a rank calls parallel/contrastive.py::"
        "global_self_paced_supcon directly",
    "parallel/contrastive.py::make_sharded_supcon_fn":
        "a shard_map + jit wrapper; a rank calls parallel/contrastive.py::"
        "sharded_self_paced_supcon directly",
    "models/masking.py::zero_grads_by_mask":
        "an optax gradient mask; the port's frozen stages have requires_grad off and the "
        "optimizer never sees them (ROADMAP C8)",
    "ops/__init__.py::FUSED_MIN_ROWS":
        "the TPU's fused/dense crossover; the port runs its kernels at every batch size "
        "(spcl_torch/hooks/infonce.py's docstring)",
    "training/steps.py::wrap_pretrain_style_step":
        "jit, buffer donation and the epoch-batched entry of a JAX step; the port's steps are "
        "plain callables (training/steps.py::build_pretrain_step, training/gradcache.py) "
        "and the trainer loops over the batches",
    "utils/profiling.py::profile_device_time":
        "spcl_tpu's one-call device timer, read by its pre-port scripts and bench.py; the "
        "port's device time is utils/profiling.py::kernel_times and the benchmark's trace",
    "utils/profiling.py::device_op_breakdown":
        "spcl_tpu's per-kernel totals of a trace directory; the port's are "
        "utils/profiling.py::kernel_times (chip_smoke.py) and portbench/trace.py",
    "training/steps.py::isinstance_name":
        "a class-name probe of spcl_tpu's semi step; the port's step tests "
        "isinstance(h, MixUpHook) (training/steps.py::build_semi_step)",
}


def _top_level(stmts):
    """Top-level statements, looking into `if` / `try` blocks."""
    for s in stmts:
        if isinstance(s, (ast.If, ast.Try)):
            yield from _top_level(s.body)
            yield from _top_level(s.orelse)
            for handler in getattr(s, "handlers", ()):
                yield from _top_level(handler.body)
            yield from _top_level(getattr(s, "finalbody", ()))
        else:
            yield s


def _assigned(stmt):
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def _parse(path: Path):
    return list(_top_level(ast.parse(path.read_text(), filename=str(path)).body))


def defined_names(path: Path) -> set:
    """Names a `def`, `class`, assignment or import defines at top level."""
    names = set()
    for s in _parse(path):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(s.name)
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in s.names)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(s))
    return names


def public_names(path: Path) -> dict:
    """The public names of a spcl_tpu module -> the submodule an
    `__init__.py` imports them from (None where the module defines them)."""
    names = {}
    init = path.name == "__init__.py"
    for s in _parse(path):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names[s.name] = None
        elif init and isinstance(s, ast.ImportFrom) and s.level == 1:
            for a in s.names:
                names[a.asname or a.name] = f"{s.module}.py" if s.module else None
        elif init and isinstance(s, (ast.Assign, ast.AnnAssign)):
            for n in _assigned(s):
                names.setdefault(n, None)
            if _assigned(s) == ["__all__"]:
                names.update((e.value, names.get(e.value)) for e in s.value.elts)
    return {n: src for n, src in names.items() if not n.startswith("_")}


def _rel(path: Path) -> str:
    return path.relative_to(TPU).as_posix()


def _entry(table, module: str, name: str):
    for key in (f"{module}::{name}", module):
        if key in table:
            return key
    return None


TPU_MODULES = sorted(_rel(p) for p in TPU.rglob("*.py"))


def _missing(module: str):
    """The names of `module` the port lacks, as 'name' or 'name -> target'."""
    port = PORT / module
    have = defined_names(port) if port.exists() else set()
    package = module.rsplit("/", 1)[0] + "/" if "/" in module else ""
    missing = []
    for name, src in sorted(public_names(TPU / module).items()):
        # an __init__'s re-export follows the entry of the submodule's name
        at, at_name = (package + src, name) if src else (module, name)
        if _entry(BY_DESIGN, at, at_name) or _entry(BY_DESIGN, module, name):
            continue
        moved = _entry(MOVED, at, at_name) or _entry(MOVED, module, name)
        if moved:
            target_module, target, _ = MOVED[moved]
            target = target or name
            if src:  # the port's __init__ must export the moved name
                if target not in have:
                    missing.append(f"{name} -> {module}::{target}")
            elif target not in defined_names(PORT / target_module):
                missing.append(f"{name} -> {target_module}::{target}")
        elif name not in have:
            missing.append(name)
    return missing


@pytest.mark.parametrize("module", TPU_MODULES)
def test_port_defines_every_public_name(module):
    missing = _missing(module)
    assert not missing, (f"spcl_torch/{module} lacks spcl_tpu/{module}'s {missing}; port them, "
                         f"or give each a MOVED or BY_DESIGN entry with its reason")


ENTRIES = [pytest.param(table is MOVED, key, value, id=key)
           for table in (MOVED, BY_DESIGN) for key, value in table.items()]


@pytest.mark.parametrize("moved,key,value", ENTRIES)
def test_table_entries_name_real_spcl_tpu_names(moved, key, value):
    module, _, name = key.partition("::")
    assert (TPU / module).exists(), f"{key}: no spcl_tpu/{module}"
    tpu_names = public_names(TPU / module)
    assert not name or name in tpu_names, f"{key}: spcl_tpu/{module} defines no public {name}"
    reason = value[2] if moved else value
    assert len(reason.split()) >= 5, f"{key}: give the entry its reason"
    port = PORT / module
    if moved:
        target_module, target, _ = value
        target_path = PORT / target_module
        assert target_path.exists(), f"{key}: no spcl_torch/{target_module}"
        targets = [target] if target else list(tpu_names)
        lacking = [t for t in targets if t not in defined_names(target_path)]
        assert not lacking, f"{key}: spcl_torch/{target_module} defines no {lacking}"
    elif port.exists():
        # a by-design entry for a name the port now defines is stale
        names = [name] if name else list(tpu_names)
        present = [n for n in names if n in defined_names(port)]
        assert not present, f"{key}: spcl_torch/{module} defines {present}; drop the entry"


def test_the_scan_sees_through_substrings(tmp_path):
    """A name used inside another (F.adaptive_avg_pool2d) does not define it."""
    path = tmp_path / "m.py"
    path.write_text("import torch.nn.functional as F\n"
                    "def head(x):\n    return F.adaptive_avg_pool2d(x, 1)\n"
                    "try:\n    from .a import b as c\nexcept ImportError:\n    d = 1\n")
    assert defined_names(path) == {"F", "head", "c", "d"}
    assert "adaptive_avg_pool" not in defined_names(path)
