"""Swin-Unet in spcl_torch (`Arch.name: swin_unet`) against the plain
reference `portbench/reference/swin_unet.py` on the CPU, at small sizes:
an embedding of 8 channels, heads (1, 2, 2, 4), 64-pixel inputs with
windows of 2 (stage sides 16, 8, 4, 2: stage 3 shifted, stage 4 one
unshifted window), and the published window 7 at 224 pixels (sides 56, 28,
14, 7). The weights are seeded random numbers.

Tolerances, float32 on both sides: the program computes the qkv and output
projections in the image's token order and folds the roll and the window
partition into the attention, the reference rolls and partitions copies
first, so the two round the same sums in another order. Through 16 blocks
and LayerNorms that stays under 1e-5 of the values' scale (2e-5 for the
logits after the decoder's 8 more blocks); gradients, a sum over every
token, under 1e-4 of their largest entry.

The CUDA kernels of `ops/csrc/wattn.cu` have no CPU mode: their test here
is marked `gpu` and skips without a card; on the CPU the block runs the
plain version (`ops/wattn_cuda.py::fwd_plain`), differentiated by autograd
and held to the reference, and the test of what the kernels refuse on the
card reads only shapes, dtypes and strides.
"""
import copy
import os

import numpy as np
import pytest
import torch

from portbench import compare, manifest
from portbench.counts import swin_unet as swin_counts
from portbench.drivers.base import deep_merge
from portbench.drivers.pretrain import draw_geometry
from portbench.reference import ops as ref_ops
from portbench.reference import pretrain_swin
from portbench.reference import swin_unet as ref
from spcl_torch.entry.common import build_model_from_config, build_trainer
from spcl_torch.hooks import SelfPacedINFONCEHook, feature_until_from_hooks
from spcl_torch.models import SwinUNet, UNet, set_trainable_stages, stages_from_range
from spcl_torch.models.swin_unet import SwinBlock
from spcl_torch.models.stages import elements_of, is_encoder_stage, sort_stages
from spcl_torch.ops import wattn_cuda as wa

SMALL = dict(embed_dim=8, num_heads=(1, 2, 2, 4))
SHAPES = {"64-ws2": dict(img_size=64, window_size=2), "224-ws7": dict(img_size=224, window_size=7)}
FEATURE_TOL = 1e-5   # of the features' largest magnitude (see the module docstring)
LOGIT_TOL = 2e-5
GRAD_TOL = 1e-4      # of a gradient's largest entry


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _model(seed=0, **kw):
    torch.manual_seed(seed)
    m = SwinUNet(**{**SMALL, **kw})
    with torch.no_grad():   # nonzero biases and LayerNorm shifts, so every term is held
        for name, p in m.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return m


def _shape(m: SwinUNet):
    return {"embed_dim": m.embed_dim, "depths": (2, 2, 2, 2), "num_heads": SMALL["num_heads"],
            "window_size": m.layers[0].blocks[0].attn.ws, "patch_size": 4, "mlp_ratio": 4.0}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# ------------------------------------------------------------------ construction
def test_published_widths_through_the_config():
    m = build_model_from_config({"Arch": {"name": "swin_unet"}, "Data": {"crop": 224}})
    assert isinstance(m, SwinUNet) and m.img_size == 224
    assert sum(p.numel() for p in m.parameters()) == 27168420
    assert [m.channel_dim(s) for s in m.ARCH_ELEMENTS] == [192, 384, 768, 768, 192, 96, 96, 4]
    blocks = [(b.shift, b.attn.ws, b.attn.heads) for layer in m.layers for b in layer.blocks]
    assert blocks == [(0, 7, 3), (3, 7, 3), (0, 7, 6), (3, 7, 6), (0, 7, 12), (3, 7, 12),
                      (0, 7, 24), (0, 7, 24)]
    keys = list(m.state_dict())
    assert "layers.0.blocks.1.attn.relative_position_bias_table" in keys
    assert "layers_up.1.upsample.expand.weight" in keys and "up.expand.weight" in keys
    assert not any(k.endswith(("attn_mask", "relative_position_index")) for k in keys)
    assert m.layers[0].blocks[1].attn.relative_position_bias_table.shape == (169, 3)


@pytest.mark.parametrize("arch,error", [
    ({"name": "swin_unet", "dtype": "bfloat16"}, "float32 only"),
    ({"name": "swin_unet", "small_c_layout": "pallas"}, "small_c_layout"),
    ({"name": "swin_unet", "input_dim": 2}, "1- or 3-channel"),
    ({"name": "vit"}, "Arch.name must be one of"),
])
def test_arch_dispatch_refuses(arch, error):
    with pytest.raises(ValueError, match=error):
        build_model_from_config({"Arch": arch})


def test_arch_name_defaults_to_the_unet():
    m = build_model_from_config({"Arch": {"max_channel": 32}})
    assert isinstance(m, UNet) and m.ARCH_ELEMENTS[0] == "Conv1"


def test_relative_index_matches_the_published_construction():
    for ws in (2, 4, 7):
        assert torch.equal(wa.relative_index(ws), ref.relative_position_index(ws))


@pytest.mark.parametrize("res,ws,shift", [(14, 7, 3), (56, 7, 3), (8, 2, 1), (12, 4, 2)])
def test_shift_mask_matches_the_published_construction(res, ws, shift):
    assert torch.equal(wa.shift_mask(res, res, ws, shift), ref.attn_mask(res, res, ws, shift))


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("res,ws,shifted", [(14, 7, False), (14, 7, True), (8, 2, True),
                                            (2, 2, False), (7, 7, True), (8, 4, True),
                                            (12, 4, True)])
def test_block_forward_and_backward_against_the_reference(res, ws, shifted):
    """One block, the program's (the plain path, autograd's backward)
    against the published order of operations: output, the input's and
    every weight's gradient, the bias table's included."""
    torch.manual_seed(1)
    m = SwinBlock(16, res, 2, ws, shifted, 4.0)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.3)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in m.named_parameters()}
    x = torch.randn(2, res, res, 16, requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    y = m(x)
    yr = ref.block(xr.view(2, res * res, 16), {f"b.{k}": v for k, v in w.items()}, "b", res, 2,
                   ws, ws // 2 if shifted else 0).view(2, res, res, 16)
    assert m.shift == (ws // 2 if shifted and res > ws else 0)
    assert _rel(y, yr) < FEATURE_TOL
    dy = torch.randn_like(y)
    g = torch.autograd.grad(y, [x] + list(m.parameters()), dy)
    gr = torch.autograd.grad(yr, [xr] + [w[k] for k, _ in m.named_parameters()], dy)
    for (name, _), a, b in zip([("x", None)] + list(m.named_parameters()), g, gr):
        assert _rel(a, b) < GRAD_TOL, name


def _attention_input(res=14, heads=2, hd=32, ws=7, **kw):
    qkv = torch.zeros(2, res, res, 3 * heads * hd, **kw)
    return qkv, torch.zeros((2 * ws - 1) ** 2, heads, **kw)


def test_the_kernels_take_the_swin_t_shapes():
    for res, heads in ((56, 3), (28, 6), (14, 12), (7, 24)):
        assert wa.refusal(*_attention_input(res, heads), heads, 7, 3 if res > 7 else 0) is None


@pytest.mark.parametrize("case,words", [
    ("window 2", "windows of 7"), ("head 16", "heads of 32"), ("float64", "float32"),
    ("strided", "contiguous"), ("part window", "whole windows"), ("table", "table")])
def test_the_kernels_name_what_they_refuse(case, words):
    """What `window_attention` raises on a CUDA input the kernels cannot take
    (no CUDA tensor here: `refusal` reads only shapes, dtypes and strides)."""
    heads, ws, shift = 2, 7, 3
    qkv, table = _attention_input()
    if case == "window 2":
        ws, shift = 2, 1
        table = torch.zeros(9, heads)
    elif case == "head 16":
        qkv, table = _attention_input(hd=16)
    elif case == "float64":
        qkv, table = _attention_input(dtype=torch.float64)
    elif case == "strided":
        qkv = qkv.transpose(1, 2)
    elif case == "part window":
        qkv, table = _attention_input(res=12)
    else:
        table = torch.zeros(169, heads + 1)
    why = wa.refusal(qkv, table, heads, ws, shift)
    assert why is not None and words in why, why


def test_the_plain_path_runs_off_the_card():
    """On the CPU `window_attention` is `fwd_plain`, and its backward is
    autograd's: no autograd Function of the kernels is in the graph."""
    torch.manual_seed(2)
    qkv = torch.randn(2, 8, 8, 3 * 2 * 4, requires_grad=True)
    table = torch.randn(9, 2, requires_grad=True)
    index, mask = wa.relative_index(2), wa.shift_mask(8, 8, 2, 1)
    out = wa.window_attention(qkv, table, index, mask, heads=2, ws=2, shift=1, scale=0.5)
    assert torch.equal(out, wa.fwd_plain(qkv, table, index, mask, 2, 2, 1, 0.5))
    assert "WindowAttention" not in type(out.grad_fn).__name__


@pytest.mark.gpu
def test_kernels_match_the_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window-attention kernels have no CPU mode")
    torch.manual_seed(3)
    for res, heads, shift in ((56, 3, 3), (14, 12, 3), (7, 24, 0)):
        c = 32 * heads
        qkv = torch.randn(4, res, res, 3 * c, device="cuda")
        table = torch.randn(169, heads, device="cuda")
        index = wa.relative_index(7).cuda()
        mask = wa.shift_mask(res, res, 7, shift)
        mask = None if mask is None else mask.cuda()
        assert wa.refusal(qkv, table, heads, 7, shift) is None
        out = wa.fwd_kernel(qkv, table, heads, shift, 32 ** -0.5)
        qkv_p, table_p = qkv.clone().requires_grad_(True), table.clone().requires_grad_(True)
        want = wa.fwd_plain(qkv_p, table_p, index, mask, heads, 7, shift, 32 ** -0.5)
        assert _rel(out, want) < 1e-5
        dout = torch.randn_like(out)
        got = wa.bwd_kernel(qkv, dout, table, heads, shift, 32 ** -0.5)
        want = torch.autograd.grad(want, (qkv_p, table_p), dout)
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-4


@pytest.mark.gpu
def test_a_window_the_kernels_refuse_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window-attention kernels have no CPU mode")
    m = SwinUNet(**SMALL, img_size=64, window_size=2).cuda()
    with pytest.raises(ValueError, match="windows of 7"):
        m(torch.zeros(1, 1, 64, 64, device="cuda"))


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_stage_and_the_logits_match_the_reference(shape):
    m = _model(**SHAPES[shape]).train()
    x = torch.rand(2, 1, m.img_size, m.img_size)
    got = m(x)
    w = {k: v.detach() for k, v in m.state_dict().items()}
    want = ref.forward(x, w, _shape(m))
    assert set(want) == set(m.ARCH_ELEMENTS) and torch.equal(got["logits"], got["Final"])
    for name in m.ARCH_ELEMENTS:
        assert got[name].shape == want[name].shape, name
        tol = LOGIT_TOL if name == "Final" else FEATURE_TOL
        assert _rel(got[name], want[name]) < tol, name
    assert got["Swin4"].shape == (2, 8 * m.embed_dim, m.img_size // 32, m.img_size // 32)


def test_until_stops_after_the_stage():
    m = _model(**SHAPES["64-ws2"])
    acts = m(torch.rand(1, 1, 64, 64), until="Swin4")
    assert list(acts) == ["Swin1", "Swin2", "Swin3", "Swin4"]
    with pytest.raises(KeyError):
        m(torch.rand(1, 1, 64, 64), until="Conv5")
    with pytest.raises(ValueError, match="built for 64"):
        m(torch.rand(1, 1, 32, 32))


def test_state_dict_round_trip(tmp_path):
    from spcl_torch.training.checkpoint import load_model_state_dict, save_checkpoint
    a = _model(**SHAPES["64-ws2"]).eval()
    save_checkpoint(str(tmp_path / "m.ckpt"), {"_model": a.state_dict()})
    b = SwinUNet(**SMALL, **SHAPES["64-ws2"]).eval()
    b.load_state_dict(load_model_state_dict(str(tmp_path / "m.ckpt")), strict=True)
    x = torch.rand(2, 1, 64, 64)
    assert torch.equal(a(x)["logits"], b(x)["logits"])
    assert list(a.state_dict()) == [k for k, _ in a.named_parameters()]


# ------------------------------------------------------------------ stage order
def test_stage_order_follows_the_architecture():
    assert elements_of("Swin2") == SwinUNet.ARCH_ELEMENTS
    assert elements_of("Up_conv3") == UNet.ARCH_ELEMENTS
    assert sort_stages(["SwinUp2", "Swin4", "Swin1"]) == ["Swin1", "Swin4", "SwinUp2"]
    assert is_encoder_stage("Swin4") and not is_encoder_stage("SwinUp1")
    assert stages_from_range(None, "Swin4") == ["Swin1", "Swin2", "Swin3", "Swin4"]
    assert stages_from_range("Swin4", "SwinUp2") == ["Swin4", "SwinUp3", "SwinUp2"]
    assert stages_from_range(None, "Conv3") == ["Conv1", "Conv2", "Conv3"]
    with pytest.raises(ValueError, match="different architectures"):
        stages_from_range("Conv1", "Swin4")


def test_hooks_on_swin_stages():
    enc = SelfPacedINFONCEHook(name="e", feature_name="Swin4")
    dec = SelfPacedINFONCEHook(name="d", feature_name="SwinUp2")
    assert enc.is_encoder and not dec.is_encoder
    assert feature_until_from_hooks(enc, dec) == "SwinUp2"
    m = _model(**SHAPES["64-ws2"])
    assert enc.build(m, "cpu").fc0.in_features == 8 * 8


def test_frozen_stages_take_no_gradient():
    m = _model(**SHAPES["64-ws2"])
    set_trainable_stages(m, stages_from_range(None, "Swin4"))
    trained = {k for k, p in m.named_parameters() if p.requires_grad}
    assert trained == {k for k in m.state_dict() if ref.stage_of(k) in ref.ENCODER}
    assert all(ref.stage_of(k) in m.ARCH_ELEMENTS for k in m.state_dict())


# ------------------------------------------------------------------ steps
TINY = {"data": {"canvas": 72, "slices_per_scan": [13, 13], "test_patients": 2},
        "augment": {"pretrain": {"crop": 64}, "label": {"crop": 64}},
        "program": {"Arch": {"embed_dim": 8, "num_heads": [1, 2, 2, 4], "window_size": 2},
                    "Data": {"crop": 64, "canvas": 72}}}
TINY_TRAFFIC = {"program": {"ContrastiveLoaderParams": {"scan_sample_num": 4},
                            "Trainer": {"num_batches": 3}}, "trace_steps": 2}


def _checked(tmp_path, fault=None, seed=2 ** 31 + 11):
    """The benchmark's Swin cell at the tiny size, as `portbench/readings.py`
    runs it: the checked steps through the trainer's step, then the float32
    reference from the same weights, batches and draws. (The harness's own
    run refuses a process that holds JAX, as this test process does.)"""
    man = manifest.load()
    entry = manifest.workload(man, "swin-pretrain-2n60")
    config = deep_merge(manifest.config(man, entry["config"]), TINY)
    traffic = deep_merge(manifest.traffic(entry["traffic"]), TINY_TRAFFIC)
    from portbench.drivers.pretrain import Cell
    cell = Cell(config, traffic, seed, "cpu", os.path.join(tmp_path, "run"), fault=fault)
    checked = cell.run_checked(int(traffic["check_steps"]))
    for _ in range(2):
        cell.step()
    failed = cell.failed
    inputs, program = cell.reference_inputs(), cell.program
    cell.close()
    ref32 = pretrain_swin.follow(inputs, checked["feeds"], config, program,
                                 int(traffic["window_epoch"]), "float32", "cpu")
    values = compare.gaps(checked, ref32, inputs["weights"])
    correct, checks = compare.judge(values, manifest.limits("swin-pretrain-2n60"))
    return correct and failed == 0, values, (config, inputs, program, checked, ref32)


def test_pretrain_step_follows_the_reference(tmp_path):
    """The checked steps through the trainer's `build_pretrain_step` against
    `reference/pretrain_swin.py`: the loss, the first gradient as RAdam took
    it, the leaves' change over three steps."""
    correct, v, _ = _checked(tmp_path)
    assert correct
    assert v["loss_gap"] < 1e-5 and v["grad_gap"] < 1e-3 and v["change_gap"] < 1e-3


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
def test_pretrain_faults_come_out_not_correct(fault, tmp_path):
    assert _checked(tmp_path, fault)[0] is False


def test_the_bf16_control_is_not_correct(tmp_path):
    """The reference under bf16 autocast (the precision below the
    configuration's float32) leaves the cell's limits."""
    _, _, (config, inputs, program, checked, ref32) = _checked(tmp_path, seed=5)
    low = pretrain_swin.follow(inputs, checked["feeds"], config, program, 38, "bfloat16", "cpu")
    limits = manifest.limits("swin-pretrain-2n60")
    assert not compare.judge(compare.gaps(low, ref32, inputs["weights"]), limits)[0]


def _trainer(name, tmp_path, **extra):
    config = {"RandomSeed": 3,
              "Arch": {"name": "swin_unet", "embed_dim": 8, "num_heads": [1, 2, 2, 4],
                       "window_size": 2, "num_classes": 4, "input_dim": 1},
              "Optim": {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5},
              "Data": {"name": "acdc", "synthetic": True, "synthetic_scans": 6,
                       "synthetic_test_scans": 4, "canvas": 72, "crop": 64,
                       "labeled_scan_num": 2},
              "LabeledLoader": {"batch_size": 3}, "UnlabeledLoader": {"batch_size": 2},
              "Trainer": {"name": name, "num_batches": 2, "max_epoch": 1, "save_dir": str(tmp_path)},
              **extra}
    tr = build_trainer(config, save_dir=str(tmp_path), device="cpu")
    tr.init()
    return tr, config


def _label_view(gen, n, policy, canvas):
    return {"geo": draw_geometry(gen, n, policy, canvas, "cpu")}


POLICY = {"crop": 64, "rot_degrees": 30.0, "rotate_after_crop": True, "hflip": False,
          "vflip": False, "brightness": [0.5, 1.5], "contrast": [0.5, 1.5], "jitter": False,
          "flip_threshold": 0.8}


def test_finetune_step_loss_against_the_reference(tmp_path):
    tr, config = _trainer("ft", tmp_path)
    w = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    ds = tr._labeled_loader.dataset
    rows = np.arange(3)
    gen = torch.Generator().manual_seed(4)
    params = {"aug": _label_view(gen, 3, POLICY, 72)}
    out = tr._train_step(torch.as_tensor(ds.to_global(rows)), tr._generator, params=params)
    root = _root(ds)
    g = ds.to_global(rows)
    x = ref_ops.gather_images(root.images, g, "cpu")
    y = torch.as_tensor(root.labels[g]).long()
    img = ref_ops.view(x, params["aug"]["geo"], None, POLICY)
    lab = ref_ops.warp_label(y, params["aug"]["geo"], 64, True)
    logits = ref.forward(img, w, _shape(tr.model))["Final"]
    want = ref_ops.masked_ce(logits, lab, 4)
    assert abs(float(out["sup_loss"]) - float(want)) < 1e-5 * abs(float(want))
    stats = ref_ops.dice_stats(logits.argmax(dim=1), lab, 4)
    assert torch.equal(out["union"].cpu().float(), stats["union"])


def _root(ds):
    while hasattr(ds, "dataset"):
        ds = ds.dataset
    return getattr(ds, "root", ds)


def test_semi_step_losses_against_the_reference(tmp_path):
    """The mean-teacher semi step with Swin-Unet: the labeled view's
    cross-entropy and the mean-teacher term (the teacher starts as the
    student), as `reference/semi.py` defines them, with the reference's
    Swin-Unet."""
    tr, config = _trainer("semi", tmp_path, MeanTeacherParams={"weight": 10, "alpha": 0.999})
    w = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    lds, uds = tr._labeled_loader.dataset, tr._unlabeled_loader.dataset
    rl, ru = np.arange(3), np.arange(2)
    gen = torch.Generator().manual_seed(5)
    unl = draw_geometry(gen, 2, POLICY, 72, "cpu")
    fp = {"fh": torch.tensor([True, False]), "fv": torch.tensor([False, True])}
    params = {"lab": _label_view(gen, 3, POLICY, 72), "unl": {"geo1": unl, "geo2": unl},
              "flip": fp}
    scalars = tr._hook_scalars()
    out = tr._train_step(torch.as_tensor(lds.to_global(rl)), torch.as_tensor(uds.to_global(ru)),
                         tr._generator, scalars, params=params)
    root = _root(lds)
    gl, gu = lds.to_global(rl), uds.to_global(ru)
    x_l = ref_ops.gather_images(root.images, gl, "cpu")
    lab = ref_ops.warp_label(torch.as_tensor(root.labels[gl]).long(), params["lab"]["geo"], 64,
                             True)
    img_l = ref_ops.view(x_l, params["lab"]["geo"], None, POLICY)
    x_u = ref_ops.gather_images(root.images, gu, "cpu")
    img_u = ref_ops.view(x_u, unl, None, POLICY)
    img_u_tf = ref_ops.flip(img_u, fp)
    shape = _shape(tr.model)
    logits = ref.forward(torch.cat([img_l, img_u, img_u_tf]), w, shape)["Final"]
    sup = ref_ops.masked_ce(logits[:3], lab, 4)
    teacher = ref_ops.flip(ref.forward(img_u, w, shape)["Final"], fp)
    reg = 10 * ref_ops.prob_mse(logits[5:], teacher)
    assert abs(float(out["sup_loss"]) - float(sup)) < 1e-5 * abs(float(sup))
    assert abs(float(out["reg_loss"]) - float(reg)) < 1e-4 * abs(float(reg))


def test_eval_and_training_epochs_run(tmp_path):
    """A fine-tune trainer's epoch and its eval over the val and test scans
    with Swin-Unet, on the CPU: the val score is a finite Dice and the
    epoch's row and checkpoints are written."""
    tr, _ = _trainer("ft", tmp_path)
    score = tr.start_training()
    assert np.isfinite(score) and 0.0 <= score <= 1.0
    assert (tmp_path / "storage.csv").exists() and (tmp_path / "last.ckpt").exists()


def test_decoder_pretraining_trains_the_bottleneck_up(tmp_path):
    tr, _ = _trainer("pretrain_decoder", tmp_path,
                     SPInfonceParams={"feature_names": "SwinUp2", "weights": 0.1,
                                      "contrast_ons": "partition"},
                     ContrastiveLoaderParams={"scan_sample_num": 2, "partition_sample_num": 1})
    trained = {ref.stage_of(k) for k, p in tr.model.named_parameters() if p.requires_grad}
    assert trained == {"Swin4", "SwinUp3", "SwinUp2"}


def test_a_checkpoint_of_another_architecture_is_refused(tmp_path):
    from spcl_torch.training.checkpoint import save_checkpoint
    save_checkpoint(str(tmp_path / "unet.ckpt"), {"_model": UNet(max_channel=16).state_dict()})
    with pytest.raises(ValueError, match="holds no weight of this model"):
        _trainer("ft", tmp_path, Arch={"name": "swin_unet", "embed_dim": 8,
                                        "num_heads": [1, 2, 2, 4], "window_size": 2,
                                        "checkpoint": str(tmp_path / "unet.ckpt")})


def test_a_swin_checkpoint_exports_and_serves(tmp_path):
    """Serving builds the model through `entry/common.py` too: a Swin-Unet
    checkpoint exported with `torch.export` and loaded back gives the
    model's eval-mode logits (NHWC in, as the server takes it)."""
    from spcl_torch import serving
    from spcl_torch.training.checkpoint import save_checkpoint
    cfg = {"Arch": {"name": "swin_unet", "embed_dim": 8, "num_heads": [1, 2, 2, 4],
                    "window_size": 2}, "Data": {"crop": 64}}
    m = _model(**SHAPES["64-ws2"]).eval()
    save_checkpoint(str(tmp_path / "m.ckpt"), {"_model": m.state_dict()})
    meta = serving.export_from_checkpoint(str(tmp_path / "m.ckpt"), str(tmp_path / "m.spclt"),
                                          config=cfg, height=64, width=64)
    assert meta["input_shape"][1:] == ["64", "64", "1"] and meta["max_channel"] is None
    served = serving.load_artifact(str(tmp_path / "m.spclt"), device="cpu")
    x = np.random.default_rng(0).random((2, 64, 64, 1), dtype=np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x).permute(0, 3, 1, 2))["logits"]
    got = served(x)["logits"]
    assert got.shape == (2, 64, 64, 4)
    assert _rel(got, want.permute(0, 2, 3, 1)) < FEATURE_TOL


# ------------------------------------------------------------------ counts
def test_counts_at_the_published_widths():
    program = copy.deepcopy(manifest.config(manifest.load(), "swinunet-t-spinfonce-pretrain")
                            ["program"])
    cfg = {"driver": "pretrain"}
    # a view's encoder: four layers of 2 blocks (24 N C^2 + 4 N 49 C each),
    # three mergings (4 N C^2 at the input's N), the 4x4 patch embedding
    hand = sum(2 * (24 * n * c * c + 4 * n * 49 * c) for n, c in
               ((3136, 96), (784, 192), (196, 384), (49, 768)))
    hand += sum(4 * n * c * c for n, c in ((3136, 96), (784, 192), (196, 384)))
    hand += 2 * 48 * 96 * 3136
    assert swin_counts.forward_flops(program, "Swin4") == hand
    assert swin_counts.flops_per_step(cfg, program) == pytest.approx(1.1047e12, rel=1e-3)
    bound = swin_counts.stage_bound_s_per_step(cfg, program)
    elems = 60 * 2 * (3136 * 96 + 784 * 192 + 196 * 384 + 49 * 768)
    assert bound == pytest.approx(11 * 4 * elems / 3.35e12, rel=1e-9)   # bytes bind


def test_the_roofline_reader_matches_the_kernels_by_name():
    import importlib.util
    spec = importlib.util.spec_from_file_location("r", manifest.metric_file("swin.wattn_roofline"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = [("void (anonymous namespace)::wattn_fwd_kernel(float const*, ...)", 300.0),
               ("void (anonymous namespace)::wattn_bwd_kernel(float const*, ...)", 600.0),
               ("wattn_dbias_kernel", 100.0), ("sm90_xmma_gemm_f32f32", 5000.0)]
    ctx = {"trace": {"kernels": kernels, "steps": 2}, "stage_bound_s": 0.5e-3}
    assert mod.read(ctx) == pytest.approx(100.0 * 0.5e-3 * 2 / 1e-3)
    assert mod.read({**ctx, "trace": {"kernels": kernels[3:], "steps": 2}}) is None
    assert mod.read({**ctx, "stage_bound_s": None}) is None
