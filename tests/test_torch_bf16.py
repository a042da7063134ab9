"""`Arch.dtype: bfloat16` in spcl_torch against spcl_tpu's bf16 path, on the CPU.

The same numpy arrays and transplanted weights go through both packages;
spcl_tpu's fused stage runs its Pallas kernels in interpret mode, the port
the plain versions of its CUDA kernels (which round where the kernels do).

Tolerances are relative L2 errors against spcl_tpu's bf16 result. Each is
measured against spcl_tpu's own bf16-vs-float32 gap on the same input and
must be at most a quarter of it (`QUARTER`), and at most the bound written
here:
- the fused stage alone (`external_first` true and false): every output and
  gradient within `STAGE_TOL` = 2e-3 (measured up to 1.0e-3, dx of the
  16->32 stage; spcl_tpu's own gap 4e-4 to 8e-2);
- the UNet-256 to Conv2 under `nhwc` (train and eval) and `pallas` (train):
  `UNET_TOL` = 2e-3 (measured 0 under `nhwc` in train mode; 6.5e-4 at Conv2
  in eval, where torch's and XLA's float32 rsqrt differ in the last place
  and so, now and then, the bf16 BatchNorm multiplier; 9.1e-5 under
  `pallas`; spcl_tpu's own gap at Conv2 about 1e-2);
- one bf16 pretrain step in lockstep (UNet-128 to Conv5 under `nhwc`, the
  self-paced SupCon head): the loss within `LOSS_TOL` = 1e-5 (measured 0),
  the head's and Conv5's gradients within `GRAD_TOL` = 1e-2 (measured 2.1e-6
  and 6.7e-3; spcl_tpu's own gap 0.24-0.31).
spcl_tpu's jitted programs run with XLA's `xla_allow_excess_precision` off
(`ROUND_EVERY_OP`), so that each bf16 operation rounds as the program writes
it, as in its eager execution and in the port; with it on, XLA:CPU keeps
float32 between fused bf16 operations and the step's head gradient moves by
0.19, as far as the bf16-vs-float32 gap itself.
Parameters, gradients and BatchNorm buffers stay float32. Last, the
counterpart of spcl_tpu's tests/test_bf16.py oracle: a 2-epoch bf16
fine-tune learns (finite `tra/sup_loss/mean`, DSC in [0, 1]).
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.experimental.packed_block_pallas import fused_packed_block
from spcl_tpu.experimental.packed_stage import pack, unpack
from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_torch.data import augment as aug
from spcl_torch.data import get_data
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.entry import build_model_from_config
from spcl_torch.hooks import SelfPacedINFONCEHook
from spcl_torch.models import (UNet, head_state_dict_from_flax, set_trainable_stages,
                               stages_from_range, unet_state_dict_from_flax)
from spcl_torch.ops import convstage_cuda as cs
from spcl_torch.training import (FineTuneTrainer, batch_to_device, build_optimizer,
                                 build_pretrain_step)
from test_torch_convstage import _stage_arrays
from test_torch_port_model import random_flax_unet
from test_torch_port_pretrain import _random_encoder, _random_head
from torch_port_helpers import jax_step_draws

QUARTER = 0.25
STAGE_TOL = 2e-3
UNET_TOL = 2e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-2
BF16 = torch.bfloat16
# XLA:CPU keeps float32 between fused bf16 operations of a jitted program
# unless told not to; off, every bf16 operation rounds as the program writes
# it (and as its eager execution does)
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _hold(what, got, want_bf16, want_f32, tol):
    """got vs spcl_tpu's bf16 within `tol` and within a quarter of spcl_tpu's
    own bf16-vs-float32 gap."""
    err, gap = _rel(got, want_bf16), _rel(want_bf16, want_f32)
    assert err <= tol, (what, err, tol)
    assert err <= QUARTER * gap, (what, err, gap)


# ------------------------------------------------------------------ the fused stage
def _jax_stage(a, external_first, c_out, dtype):
    """spcl_tpu's `fused_packed_block` in `dtype` (interpret mode, jitted with
    every bf16 operation rounded): outputs (p, e, statistics) and the
    gradients of sum(p * cp) + sum(e * ce)."""
    cw = a["x"].shape[3]
    names = ("x", "w0", "g0", "b0", "w1", "g1", "b1")
    xpad = jnp.pad(pack(jnp.asarray(a["x"]).astype(dtype)), ((0, 0), (1, 1), (1, 1), (0, 0)))
    jargs = (xpad,) + tuple(jnp.asarray(a[k]) for k in names[1:])

    def loss(*args):
        out = fused_packed_block(*args, cw, c_out, dtype, external_first)
        p, e = (unpack(o, c_out).astype(jnp.float32) for o in out[:2])
        return jnp.sum(p * a["cp"]) + jnp.sum(e * a["ce"]), (p, e) + tuple(out[2:])

    fn = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))
    (_, out), grads = fn.lower(*jargs).compile(compiler_options=ROUND_EVERY_OP)(*jargs)
    g = dict(zip(names, (np.asarray(v, np.float32) for v in grads)))
    g["x"] = np.asarray(unpack(grads[0][:, 1:-1, 1:-1, :].astype(jnp.float32), cw))
    return [np.asarray(o, np.float32) for o in out], g


@pytest.mark.parametrize("external_first,c_in,c_out", [(True, 16, 16), (False, 16, 32)],
                         ids=["external16", "expand16to32"])
def test_bf16_stage_matches_fused_packed_block(external_first, c_in, c_out):
    a = _stage_arrays(external_first, c_in, c_out)
    names = ("x", "w0", "g0", "b0", "w1", "g1", "b1")
    want, want_g = _jax_stage(a, external_first, c_out, "bfloat16")
    f32, f32_g = _jax_stage(a, external_first, c_out, "float32")

    targs = {k: torch.from_numpy(a[k].copy()).requires_grad_(True) for k in names[1:]}
    x = torch.from_numpy(a["x"]).to(BF16).requires_grad_(True)
    out = cs.fused_conv_stage(x, *(targs[k] for k in names[1:]), external_first=external_first)
    assert out[0].dtype == out[1].dtype == BF16
    assert all(o.dtype == torch.float32 for o in out[2:])
    ((out[0].float() * torch.from_numpy(a["cp"])).sum()
     + (out[1].float() * torch.from_numpy(a["ce"])).sum()).backward()
    for name, got, w, f in zip(("p", "e", "mean0", "var0", "mean1", "var1"), out, want, f32):
        _hold(name, got.detach().float().numpy(), w, f, STAGE_TOL)
    assert x.grad.dtype == BF16
    grads = {k: t.grad for k, t in targs.items()}
    grads["x"] = x.grad.float()
    for name in names:
        if external_first and name == "w0":
            assert grads[name] is None
            continue
        assert name == "x" or grads[name].dtype == torch.float32
        _hold(f"d{name}", grads[name].numpy(), want_g[name], f32_g[name], STAGE_TOL)


# ------------------------------------------------------------------ the UNet
@pytest.fixture(scope="module")
def unet_case():
    """spcl_tpu's UNet-256 to Conv2 on one 2x32x32 input, in float32 (`nhwc`,
    the reference of the gap) and bf16 (`nhwc`, `pallas`), train and eval;
    and the transplanted weights."""
    rng = np.random.default_rng(3)
    params, stats = random_flax_unet(rng, max_channel=256)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    out = {}
    for dtype, layout, train in (("float32", "nhwc", True), ("bfloat16", "nhwc", True),
                                 ("float32", "nhwc", False), ("bfloat16", "nhwc", False),
                                 ("bfloat16", "pallas", True)):
        net = JaxUNet(input_dim=1, num_classes=4, max_channel=256, small_c_layout=layout,
                      dtype=jnp.dtype(dtype))
        variables = {"params": params, "batch_stats": stats}
        if train:
            acts, _ = net.apply(variables, jnp.asarray(x), train=True, until="Conv2",
                                mutable=["batch_stats"])
        else:
            acts = net.apply(variables, jnp.asarray(x), train=False, until="Conv2")
        out[(dtype, layout, train)] = {
            k: np.transpose(np.asarray(v.astype(jnp.float32)), (0, 3, 1, 2))
            for k, v in acts.items()}
    sd = {k: torch.from_numpy(v) for k, v in unet_state_dict_from_flax(params, stats).items()}
    return dict(jax=out, sd=sd, x=torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))


@pytest.mark.parametrize("layout,train", [("nhwc", True), ("nhwc", False), ("pallas", True)],
                         ids=["nhwc-train", "nhwc-eval", "pallas-train"])
def test_bf16_unet_matches_spcl_tpu(unet_case, layout, train):
    net = UNet(max_channel=256, small_c_layout=layout, dtype=BF16)
    net.load_state_dict(unet_case["sd"], strict=True)
    net.train(train)
    with torch.no_grad():
        acts = net(unet_case["x"], until="Conv2")
    want, f32 = unet_case["jax"][("bfloat16", layout, train)], unet_case["jax"][("float32",
                                                                                "nhwc", train)]
    assert set(acts) == set(want)
    for name, got in acts.items():
        assert got.dtype == BF16, name
        _hold(name, got.float().numpy(), want[name], f32[name], UNET_TOL)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in net.buffers())


def test_bf16_config_builds_a_bf16_unet():
    net = build_model_from_config({"Arch": {"dtype": "bfloat16", "max_channel": 128}})
    assert net.dtype == BF16
    with pytest.raises(ValueError, match="Arch.dtype"):
        build_model_from_config({"Arch": {"dtype": "float16"}})


# ------------------------------------------------------------------ one pretrain step
def _step_pair():
    """One bf16 pretrain step of each package (UNet-128 to Conv5, `nhwc`),
    spcl_tpu's in float32 too: (loss, {head/Conv5 gradient name: array}) per
    run, and the port's."""
    rng = np.random.default_rng(0)
    params, stats = _random_encoder(rng)
    head = _random_head(rng, 128)
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=40, seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    next(iter(jax_contrastive_loader(jds, scan_sample_num=2,
                                                                     seed=3))))
    pds = synthetic_dataset("acdc", num_scans=4, canvas=40, seed=0)
    pbatch = next(iter(create_contrastive_loader(pds, scan_sample_num=2, seed=3)))
    n, gamma, key = jbatch["image"].shape[0], 3.0, jax.random.PRNGKey(42)
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=32)
    jhook = JaxSPHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                      begin_value=3, end_value=14, max_epoch=2)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=128, dtype=jnp.dtype(dtype))

        def loss_fn(p):  # spcl_tpu/training/steps.py:420-445
            k_aug, k_flip, k_hooks = jax.random.split(key, 3)
            image = jbatch["image"].astype(jnp.float32) / 255.0
            (v1, _), (v2, _) = jaug.augment_twice(k_aug, image, None, jpol,
                                                  total_freedom=True, sizes=jbatch["size"])
            fp = jaug.flip_params(k_flip, n, threshold=0.8)
            acts, _ = jnet.apply({"params": p["model"], "batch_stats": stats},
                                 jnp.concatenate([v1, jaug.apply_flip(v2, fp)]), train=True,
                                 until="Conv5", mutable=["batch_stats"])
            ctx = {"acts": acts, "n_unl": n, "flip": fp, "mesh": None, "key": k_hooks,
                   **{k: jbatch[k] for k in ("partition", "patient", "cycle", "scan_idx",
                                             "valid")}}
            return jhook.loss_fn(p["hook"], ctx, {"gamma": jnp.float32(gamma)})[0]

        args = ({"model": params, "hook": head},)
        loss, g = jax.jit(jax.value_and_grad(loss_fn)).lower(*args).compile(
            compiler_options=ROUND_EVERY_OP)(*args)
        runs[dtype] = (float(loss), {
            "fc0": np.asarray(g["hook"]["params"]["fc0"]["kernel"]).T,
            "fc1": np.asarray(g["hook"]["params"]["fc1"]["kernel"]).T,
            "conv5_1": np.transpose(np.asarray(g["model"]["Conv5"]["conv1"]["kernel"]),
                                    (3, 2, 0, 1))})

    net = UNet(input_dim=1, num_classes=4, max_channel=128, dtype=BF16)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats, allow_partial=True).items()},
                        strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                                begin_value=3, end_value=14, max_epoch=2)
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in head_state_dict_from_flax(head).items()})
    opt = build_optimizer([p for p in net.parameters() if p.requires_grad]
                          + hook.parameters(), lr=1e-3, weight_decay=1e-5)
    step = build_pretrain_step(net, [hook], opt, until="Conv5", total_freedom=True,
                               policy=dataclasses.replace(aug.ACDC_PRETRAIN, crop=32))
    metrics = step(batch_to_device(pbatch, "cpu"), None, {"sp": {"gamma": gamma}},
                   params=jax_step_draws(key, n, jpol, 40, sizes=jbatch["size"]))
    port = (float(metrics["reg_loss"]), {"fc0": hook.projector.fc0.weight.grad,
                                         "fc1": hook.projector.fc1.weight.grad,
                                         "conv5_1": net._Conv5.conv[3].weight.grad})
    return runs, port, net


def test_bf16_pretrain_step_in_lockstep():
    runs, (loss, grads), net = _step_pair()
    (want, want_g), (loss32, f32_g) = runs["bfloat16"], runs["float32"]
    assert abs(loss - want) <= LOSS_TOL * abs(want), (loss, want)
    assert abs(loss - want) <= QUARTER * abs(want - loss32), (loss, want, loss32)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        _hold(name, g.numpy(), want_g[name], f32_g[name], GRAD_TOL)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in net.buffers())


# ------------------------------------------------------------------ the oracle
def test_bf16_finetune_learns(tmp_path):
    """spcl_tpu tests/test_bf16.py::test_bf16_finetune_learns on the port: two
    bf16 fine-tune epochs train, evaluate and checkpoint; the loss is finite,
    the DSC in [0, 1], the parameters float32."""
    tra = synthetic_dataset("acdc", num_scans=4, slices_per_scan=(4, 6), canvas=40, seed=0)
    test = synthetic_dataset("acdc", num_scans=3, slices_per_scan=(4, 6), canvas=40, seed=1,
                             mode="val")
    lab, _, val, _ = get_data(tra_set=tra, test_set=test, labeled_scan_num=2,
                              labeled_batch_size=3, unlabeled_batch_size=3,
                              load_predefined_list=False)
    model = UNet(input_dim=1, num_classes=4, max_channel=128, dtype=BF16)
    tr = FineTuneTrainer(model=model, labeled_loader=lab, val_loader=val, test_loader=None,
                         save_dir=str(tmp_path), max_epoch=2, num_batches=2,
                         config={"Optim": {"name": "adam", "lr": 1e-3}}, crop=32,
                         data_name="acdc", device="cpu")
    tr.init()
    score = tr.start_training()
    assert 0.0 <= score <= 1.0
    rows = list(csv.DictReader(open(tmp_path / "storage.csv")))
    assert len(rows) == 2 and all(np.isfinite(float(r["tra/sup_loss/mean"])) for r in rows)
    assert model._Conv1.conv[0].weight.dtype == torch.float32
    assert (tmp_path / "best.ckpt").exists() and (tmp_path / "last.ckpt").exists()
