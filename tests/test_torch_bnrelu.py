"""The fused BatchNorm + ReLU (`ops/bnrelu_cuda.py`), the device-tensor step
terms of RAdam (`training/optim.py`) and the graphed pretrain step's host
side (`training/steps.py::GraphedStep`), on the CPU with torch on one thread.

- The plain versions (what the CUDA kernels compute, in float64 sums) as the
  UNet's BatchNorm + ReLU pair runs them (`CrossRankBatchNorm2d.fused_relu`)
  against `nn.BatchNorm2d` + ReLU: the output, dx, dweight, dbias and the
  running statistics, with the statistics updated, frozen, under
  `torch.no_grad()` and with `rank_local` statistics under a process group;
  eval mode, channels-last and bfloat16 inputs and cross-rank statistics
  stay on their paths. Tolerance: 1e-6 of each tensor's largest value
  (nn.BatchNorm2d sums in float32 on the CPU, the plain versions in
  float64), the running statistics 1e-6 relative.
- The same at the UNet-256's BatchNorm shapes (Conv1..Conv5 and the
  decoder's), at N = 2 and a small canvas.
- The kernels' division by a multiply-high and a shift is exact over the
  unit indices they take; the launch plan covers every unit once.
- RAdam's step-count terms on a float32 tensor equal the host's float32
  numpy terms to the bit for t = 1..10 (rho crosses the threshold 5 at t = 6)
  and at t = 7,000; a loaded checkpoint's integer step counts become one
  shared tensor; the step counts are tensors after a step.
- The pretrain step returns new metric tensors every step, and its tree
  helpers key a capture on what it is specific to.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch import nn

from spcl_torch.models.norm import (CrossRankBatchNorm2d, bn_relu, frozen_statistics, fusable,
                                    fused_bn_relu_engages, rank_local_statistics)
from spcl_torch.ops import bnrelu_cuda as br
from spcl_torch.training import RAdam
from spcl_torch.training import optim as optim_lib
from spcl_torch.training import steps as steps_lib


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(c, seed):
    """Our module and nn.BatchNorm2d from the same random state."""
    g = torch.Generator().manual_seed(seed)
    ours, ref = CrossRankBatchNorm2d(c), nn.BatchNorm2d(c)
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(torch.rand(c, generator=torch.Generator().manual_seed(seed)) + 0.5)
            m.bias.copy_(torch.randn(c, generator=torch.Generator().manual_seed(seed + 1)) * 0.2)
            m.running_mean.copy_(torch.randn(c, generator=torch.Generator().manual_seed(2)) / 9)
            m.running_var.copy_(torch.rand(c, generator=torch.Generator().manual_seed(3)) + 0.5)
    return ours, ref, g


def _close(got, want, scale=1e-6):
    torch.testing.assert_close(got, want, rtol=0, atol=scale * max(float(want.detach().abs().max()), 1e-12))


def _run(shape, seed, frozen=False, grad=True):
    c = shape[1]
    ours, ref, g = _pair(c, seed)
    x = torch.randn(shape, generator=g) * 0.7 + 0.3
    dy = torch.randn(shape, generator=g)
    xo, xr = (x.clone().requires_grad_(grad) for _ in range(2))
    ctx = torch.no_grad() if not grad else contextlib.nullcontext()
    with ctx:
        if frozen:
            with frozen_statistics(ours):
                yo = ours.fused_relu(xo)
            yr = torch.relu(nn.functional.batch_norm(xr, None, None, ref.weight, ref.bias, True,
                                                     0.0, 1e-5))
        else:
            yo = ours.fused_relu(xo)
            yr = torch.relu_(ref(xr))
    _close(yo, yr)
    if grad:
        yo.backward(dy)
        yr.backward(dy)
        for got, want in ((xo.grad, xr.grad), (ours.weight.grad, ref.weight.grad),
                          (ours.bias.grad, ref.bias.grad)):
            _close(got, want)
    if frozen:
        before, _, _ = _pair(c, seed)
        assert torch.equal(ours.running_mean, before.running_mean)
        assert torch.equal(ours.running_var, before.running_var)
        assert int(ours.num_batches_tracked) == 0
    else:
        torch.testing.assert_close(ours.running_mean, ref.running_mean, rtol=1e-6, atol=1e-8)
        torch.testing.assert_close(ours.running_var, ref.running_var, rtol=1e-6, atol=0)
        assert int(ours.num_batches_tracked) == int(ref.num_batches_tracked) == 1


@pytest.mark.parametrize("case", ["update", "frozen", "no_grad"])
def test_plain_bnrelu_matches_batchnorm2d(case):
    _run((3, 8, 12, 10), seed=4, frozen=case == "frozen", grad=case != "no_grad")


def test_rank_local_statistics_take_the_fused_pair(monkeypatch):
    """Under a process group the pair is fused only with `rank_local`
    statistics (the gradient cache's chunks), and computes this rank's
    BatchNorm then."""
    from spcl_torch.parallel import mesh
    monkeypatch.setattr(mesh, "active", lambda: True)
    model = nn.Sequential(CrossRankBatchNorm2d(8))
    x = torch.randn(2, 8, 6, 6)
    assert not fusable(model[0], x)
    with rank_local_statistics(model):
        assert fusable(model[0], x)
        y = model[0].fused_relu(x)
    ref = nn.BatchNorm2d(8)
    _close(y, torch.relu(ref(x)))


def test_other_inputs_keep_their_paths():
    """Eval mode, channels-last, bfloat16 and the CPU: `bn_relu` is the two
    modules there (eval: the running statistics)."""
    norm, relu = CrossRankBatchNorm2d(8), nn.ReLU(inplace=True)
    x = torch.randn(4, 8, 6, 6)
    assert fusable(norm, x) and not fused_bn_relu_engages(norm, x)  # the CPU
    assert not fusable(norm, x.to(memory_format=torch.channels_last))
    assert not fusable(norm, x.bfloat16())
    norm.eval()
    assert not fusable(norm, x)
    with torch.no_grad():
        norm.running_mean.fill_(0.5)
        norm.running_var.fill_(2.0)
    want = torch.relu((x - 0.5) / torch.sqrt(torch.tensor(2.0 + 1e-5)))
    _close(bn_relu(norm, relu, x.clone()), want)


# the UNet-256's BatchNorm widths, at N = 2 on a 16 x 16 canvas: Conv1..Conv5,
# then Up_conv5..Up_conv2 (the decoder's ConvBlock and UpConv)
UNET_SHAPES = [(2, 16, 16, 16), (2, 32, 8, 8), (2, 64, 4, 4), (2, 128, 2, 2), (2, 256, 1, 1),
               (2, 128, 2, 2), (2, 64, 4, 4), (2, 32, 8, 8), (2, 16, 16, 16)]


@pytest.mark.parametrize("shape", UNET_SHAPES,
                         ids=["Conv1", "Conv2", "Conv3", "Conv4", "Conv5", "Up_conv5",
                              "Up_conv4", "Up_conv3", "Up_conv2"])
def test_plain_bnrelu_at_the_unet_shapes(shape):
    _run(shape, seed=shape[1])


def test_kernel_division_and_plan_are_exact():
    rng = np.random.default_rng(0)
    for d in [1, 2, 3, 7, 49, 196, 784, 3136, 12544, 50176, 2 ** 20 + 7, 2 ** 31 - 1]:
        m, s = br.fast_div(d)
        assert 0 < m < 2 ** 32
        ns = np.concatenate([[0, 1, d - 1, d, d + 1, 2 ** 31 - 1],
                             rng.integers(0, 2 ** 31, 200)]).astype(np.int64)
        for n in ns[ns < 2 ** 31].tolist():
            assert ((((m * n) >> 32) + n) >> s) == n // d, (d, n)
    p = br.plan((60, 16, 224, 224), vec=True)
    assert p["hwu"] == 224 * 224 // 4 and p["units"] == 60 * p["hwu"]
    assert (p["tiles"] - 1) * p["tile"] < p["units"] <= p["tiles"] * p["tile"]
    assert br.plan((5, 24, 7, 9), vec=False)["hwu"] == 63
    with pytest.raises(ValueError):
        br.plan((2, br.MAX_CHANNELS + 1, 4, 4), vec=True)


def test_radam_device_terms_equal_the_host_floats():
    """optax's scale_by_radam terms in float32 numpy (the host form the
    optimizer had) against `radam_terms` on a float32 tensor, to the bit."""
    f32 = np.float32
    b1, b2, threshold = 0.9, 0.999, 5.0
    ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
    crossed = []
    for t in list(range(1, 11)) + [7000]:
        b2t = f32(b2) ** f32(t)
        ro = ro_inf - f32(2) * f32(t) * b2t / (f32(1) - b2t)
        bc2, r, rectified = optim_lib.radam_terms(b2, threshold, torch.tensor(float(t)))
        assert float(bc2) == float(f32(1) - b2t)
        assert bool(rectified) == bool(ro >= threshold)
        if ro >= threshold:
            want = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                           / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
            assert float(r) == float(want)
        else:
            assert float(r) == 1.0
        bc1 = optim_lib._bias_correction(b1, torch.tensor(float(t)))
        assert float(bc1) == float(f32(1) - f32(b1) ** f32(t))
        crossed.append(bool(rectified))
    assert crossed[:10] == [False] * 5 + [True] * 5


def test_radam_step_counts_are_shared_tensors():
    params = [nn.Parameter(torch.randn(3)), nn.Parameter(torch.randn(2, 2))]
    opt = RAdam(params, lr=1e-3)
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
    steps = [opt.state[p]["step"] for p in params]
    assert steps[0] is steps[1] and steps[0].dtype == torch.float32 and float(steps[0]) == 3
    state = opt.state_dict()
    for s in state["state"].values():
        s["step"] = 3  # a checkpoint that holds ints
    fresh = RAdam(params, lr=1e-3)
    fresh.load_state_dict(state)
    steps = [fresh.state[p]["step"] for p in params]
    assert steps[0] is steps[1] and torch.is_tensor(steps[0]) and float(steps[0]) == 3


def test_pretrain_step_returns_new_metric_tensors_every_step():
    import dataclasses
    from spcl_torch.data import DeviceStore, synthetic_dataset
    from spcl_torch.data.augment import ACDC_PRETRAIN
    from spcl_torch.hooks import SelfPacedINFONCEHook
    from spcl_torch.models import UNet, set_trainable_stages, stages_from_range
    from spcl_torch.training import build_optimizer, build_pretrain_step
    torch.manual_seed(0)
    root = synthetic_dataset("acdc", num_scans=3, slices_per_scan=(6, 7), canvas=40, seed=1)
    store = DeviceStore(root, "cpu")
    net = UNet(max_channel=32)
    set_trainable_stages(net, stages_from_range(None, "Conv3"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv3", mode="hard",
                                begin_value=3.0, end_value=14.0, max_epoch=4)
    hook.build(net, "cpu")
    opt = build_optimizer([p for p in net.parameters() if p.requires_grad] + hook.parameters(),
                          name="RAdam", lr=1e-4)
    step = build_pretrain_step(net, [hook], opt, policy=dataclasses.replace(ACDC_PRETRAIN,
                                                                            crop=32),
                               total_freedom=True, until="Conv3", store=store)
    assert isinstance(step, steps_lib.GraphedStep) and not step.engages(torch.arange(6))
    gen = torch.Generator().manual_seed(2)
    outs = [step(torch.arange(6) + k, gen, {"sp": hook.epoch_scalars(0)}) for k in range(3)]
    leaves = [t for o in outs for t in pytree.tree_leaves(o) if torch.is_tensor(t)]
    assert len({id(t) for t in leaves}) == len({t.data_ptr() for t in leaves}) == len(leaves)
    assert all(torch.isfinite(o["reg_loss"]) for o in outs)


def test_step_tree_helpers_round_trip():
    """The graphed step's tree helpers: leaves by key path, and a layout that
    ignores the order of a dict's keys but not a shape, a dtype or a host
    value."""
    tree = {"b": [torch.zeros(2), (torch.ones(()), 3.0)], "a": {"x": torch.arange(3)},
            "c": None}
    flat = steps_lib._by_path(tree)
    assert sorted(k for k, v in flat.items() if torch.is_tensor(v)) == [
        "['a']['x']", "['b'][0]", "['b'][1][0]"]
    assert flat["['b'][1][1]"] == 3.0
    same = {"c": None, "a": {"x": torch.arange(3) + 5}, "b": [torch.ones(2), (torch.zeros(()),
                                                                          3.0)]}
    assert steps_lib._layout(tree) == steps_lib._layout(same)
    assert steps_lib._layout(tree) != steps_lib._layout({**tree, "c": 1.0})
    assert steps_lib._layout(tree) != steps_lib._layout({**tree, "a": {"x": torch.arange(4)}})
    assert steps_lib._layout(tree) != steps_lib._layout({**tree, "a": {"x": torch.zeros(3)}})


def test_every_kernel_module_registers_its_launch_counts():
    """A graph replay advances the launch counts of every kernel module: each
    `LAUNCHES*` dict of `spcl_torch.ops` is registered in `LAUNCH_COUNTERS`."""
    import importlib
    import pkgutil
    import spcl_torch.ops as ops
    from spcl_torch.utils.profiling import LAUNCH_COUNTERS
    found = []
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"spcl_torch.ops.{info.name}")
        found += [(info.name, k) for k, v in vars(module).items()
                  if k.startswith("LAUNCHES") and isinstance(v, dict)
                  and not any(v is c for c in LAUNCH_COUNTERS)]
    assert not found


@pytest.mark.parametrize("feature", ["Conv3", "Up_conv3"])
def test_pretrain_step_draws_only_through_its_draw(feature):
    """The pretrain step's draws, the hooks' `sample` included, are made by
    `draw_pretrain_params` alone: a step from a generator leaves it where
    the step's `draw` leaves an equal one, and gives the loss of the step
    run on those draws; injected draws are kept, and only what they lack
    is drawn."""
    import copy
    import dataclasses
    from spcl_torch.data import DeviceStore, synthetic_dataset
    from spcl_torch.data.augment import ACDC_PRETRAIN
    from spcl_torch.hooks import INFONCEHook
    from spcl_torch.models import UNet, set_trainable_stages, stages_from_range
    from spcl_torch.training import build_optimizer, build_pretrain_step
    torch.manual_seed(0)
    root = synthetic_dataset("acdc", num_scans=3, slices_per_scan=(6, 7), canvas=40, seed=1)
    store = DeviceStore(root, "cpu")
    base = UNet(max_channel=32)
    set_trainable_stages(base, stages_from_range(None, feature))
    steps = []
    for _ in range(2):
        net = copy.deepcopy(base)
        hook = INFONCEHook(name="nce", feature_name=feature, contrast_on="self",
                           spatial_size=(4, 4))
        torch.manual_seed(3)
        hook.build(net, "cpu")
        opt = build_optimizer([p for p in net.parameters() if p.requires_grad]
                              + hook.parameters(), name="RAdam", lr=1e-4)
        steps.append(build_pretrain_step(
            net, [hook], opt, policy=dataclasses.replace(ACDC_PRETRAIN, crop=32),
            total_freedom=True, until=feature, store=store))
    rows = torch.arange(6)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    drawn = steps[1].draw(rows, gens[1])
    assert ("nce" in drawn["hooks"]) == (feature == "Up_conv3")
    got = steps[0](rows, gens[0], {})
    want = steps[1](rows, None, {}, params=drawn)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert torch.equal(got["reg_loss"], want["reg_loss"])
    views = {k: drawn[k] for k in ("aug", "flip")}
    completed = steps[1].draw(rows, torch.Generator().manual_seed(6), views)
    assert completed["aug"] is views["aug"] and completed["flip"] is views["flip"]
    assert set(completed["hooks"]) == set(drawn["hooks"])
    assert steps[1].draw(rows, None, drawn) is drawn
