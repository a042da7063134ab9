"""spcl_torch's semi step (`training/steps.py::build_semi_step`) in lockstep
with spcl_tpu's, on the CPU.

Both steps start from the same weights (spcl_tpu's, transplanted; the
teacher a copy of the student, as `create_train_state(teacher=True)` makes
it), take the same labeled and unlabeled batches (the same indices of both
packages' synthetic datasets, one unlabeled row padded with valid=0), and
the port is handed the JAX step's own draws (augmentation, flips, and the
hooks' noise / mixup draws: `torch_port_helpers.jax_semi_draws`).

- Mean teacher (weight 10) + consistency (weight 5) under `nhwc`, 3 steps at
  UNet-128, crop 32 of a 40 canvas, RAdam at lr 1e-3;
- the same under `pallas` for 1 step at UNet-256 (the width at which the
  stages are packable), crop 32: the port's fused stages on their plain
  versions, spcl_tpu's Pallas kernels in interpret mode;
- `two_stage` with `disable_bn` on and off, 1 step each at UNet-128;
- the mixup branch and UC-MT together with mean teacher and consistency, 1
  step at UNet-128.

Compared: sup_loss, reg_loss and every hook metric per step (rtol 1e-4:
float32 convolutions summed in another order through the whole UNet);
Dice inter / union within 8 pixels of a 32x32 slice (argmax near-ties that
the students' last-bit differences break the other way: measured 0 in
steps 1-2 and 4 in step 3); the student's and the teacher's parameters
after the steps (atol 2e-5, measured 1.6e-5 after 3 steps: in its first
steps RAdam's update is lr x the first moment, so a parameter moves by lr
times its gradient, and tests/test_torch_port_pretrain.py bounds
Conv1-Conv3 gradients to 2e-2 relative); the BatchNorm running statistics
(rtol 1e-3, atol 1e-4, as tests/test_torch_finetune.py).

Port-only checks: `device_data` (an index vector gathered from the
DeviceStore) equals the host batch to the bit, and neither the teacher's
forwards nor the auxiliary student forwards (mixup, UC-MT's noisy passes)
move a running statistic, under both layouts.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.hooks import creator as jcreator
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_semi_step as jax_build_semi_step
from spcl_torch.data import augment as aug
from spcl_torch.data.device_store import DeviceStore
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.hooks import creator
from spcl_torch.hooks.base import get_individual_hooks
from spcl_torch.models import EMATeacher, unet_state_dict_from_flax
from spcl_torch.training import batch_to_device, build_optimizer, build_semi_step
from test_torch_finetune import _pair
from torch_port_helpers import jax_semi_draws

LR, WD = 1e-3, 1e-5
CANVAS, CROP = 40, 32
PARAM_ATOL = 2e-5
COUNT_ATOL = 8.0
MT_UDA = (("create_mt_hook", {"weight": 10.0}), ("create_consistency_hook", {"weight": 5.0}))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its CPU ops are small, and the
    suite runs test files side by side in several processes, where spinning
    intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hooks(pkg, spec):
    from spcl_tpu.hooks.base import get_individual_hooks as jflat
    flat = jflat if pkg is jcreator else get_individual_hooks
    return flat(*[getattr(pkg, f)(**kw) for f, kw in spec])


def _batches(k, n_l, n_u):
    """k (labeled, unlabeled) batch pairs, as (jax dicts, port dicts); the
    last unlabeled row of each is padding (valid 0)."""
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    rng = np.random.default_rng(21)
    out = []
    for _ in range(k):
        il = rng.choice(len(pds.images), n_l, replace=False)
        iu = rng.choice(len(pds.images), n_u, replace=False)
        iu[-1] = -1
        out.append(((jds.batch(il), jds.batch(iu)), (pds.batch(il), pds.batch(iu))))
    return out


def _lockstep(max_channel, layout, steps, seed, spec=MT_UDA, n_l=3, n_u=3, two_stage=False,
              disable_bn=False, scalars=None):
    jnet, params, stats, net = _pair(max_channel, layout, seed)
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=CROP)
    ppol = dataclasses.replace(aug.ACDC_LABEL, crop=CROP)
    jhooks, hooks = _hooks(jcreator, spec), _hooks(creator, spec)
    mixup = any(h.name == "mix_reg" for h in hooks)
    tx = jax_build_optimizer(name="RAdam", lr=LR, weight_decay=WD)
    needs_teacher = any(h.needs_teacher for h in jhooks)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={}, tx=tx,
                               teacher=needs_teacher)
    jstep = jax_build_semi_step(jnet, jhooks, tx, num_classes=4, policy=jpol,
                                two_stage=two_stage, disable_bn=disable_bn)
    opt = build_optimizer(list(net.parameters()), lr=LR, weight_decay=WD)
    teacher = EMATeacher(net) if needs_teacher else None
    step = build_semi_step(net, hooks, opt, num_classes=4, policy=ppol, two_stage=two_stage,
                           disable_bn=disable_bn, teacher=teacher)
    scalars = scalars or {}
    records = []
    for key, ((jl, ju), (pl, pu)) in zip(jax.random.split(jax.random.PRNGKey(seed + 7), steps),
                                         _batches(steps, n_l, n_u)):
        jl = jax.tree_util.tree_map(jnp.asarray, jl)
        ju = jax.tree_util.tree_map(jnp.asarray, ju)
        draws = jax_semi_draws(key, n_l, n_u, jpol, CANVAS, jl["size"], ju["size"],
                               mixup=mixup, hooks=jhooks)
        state, jm = jstep(state, jl, ju, key, scalars)
        pm = step(batch_to_device(pl, "cpu"), batch_to_device(pu, "cpu"), None, scalars,
                  params=draws)
        records.append((jax.device_get(jm), pm))
    return dict(records=records, state=jax.device_get(state), net=net, teacher=teacher)


def _close_counts(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=COUNT_ATOL,
                               err_msg=what)


def _check_metrics(jm, pm):
    for k in ("sup_loss", "reg_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert sorted(pm["hooks"]) == sorted(jm["hooks"])
    for name, m in jm["hooks"].items():
        assert sorted(pm["hooks"][name]) == sorted(m)
        for k, v in m.items():
            np.testing.assert_allclose(float(pm["hooks"][name][k]), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{name}/{k}")
    _close_counts(pm["inter"], jm["inter"], "inter")
    _close_counts(pm["union"], jm["union"], "union")


def _check_parameters(net, params, what):
    want = unet_state_dict_from_flax(params, _zero_stats(params))
    got = net.state_dict()
    checked = 0
    for k, v in want.items():
        if "running" in k or "num_batches" in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {k}")
        checked += 1
    assert checked == len(list(net.parameters()))


def _zero_stats(params):
    """batch_stats-shaped zeros for a params tree (the teacher has none)."""
    def walk(p):
        if "scale" in p:
            return {"mean": np.zeros_like(p["scale"]), "var": np.zeros_like(p["scale"])}
        return {k: walk(v) for k, v in p.items() if isinstance(v, dict)}
    return walk(params)


def _check_running_statistics(net, stats):
    want = unet_state_dict_from_flax(_params_like(stats), stats)
    got = net.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-3, atol=1e-4, err_msg=k)


def _params_like(stats):
    """A params-shaped tree for a batch_stats tree (kernels are not read
    for the comparison of statistics)."""
    def walk(s):
        if "mean" in s:
            return {"scale": s["mean"], "bias": s["mean"]}
        return {k: walk(v) for k, v in s.items()}
    p = walk(stats)
    for block in list(p):
        for conv in ("conv0", "conv1", "conv"):
            p[block][conv] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    p["Deconv_1x1"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32),
                       "bias": np.zeros((1,), np.float32)}
    return p


@pytest.fixture(scope="module")
def nhwc_run():
    return _lockstep(128, "nhwc", 3, seed=0)


@pytest.fixture(scope="module")
def pallas_run():
    return _lockstep(256, "pallas", 1, seed=1, n_l=2, n_u=2)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_semi_steps_track_spcl_tpu(nhwc_run, k):
    _check_metrics(*nhwc_run["records"][k])


@pytest.mark.parametrize("run", ["nhwc_run", "pallas_run"])
def test_semi_student_teacher_and_statistics_track_spcl_tpu(request, run):
    r = request.getfixturevalue(run)
    if run == "pallas_run":
        _check_metrics(*r["records"][0])
    state = r["state"]
    _check_parameters(r["net"], state.params["model"], "student")
    _check_parameters(r["teacher"].model, state.teacher_params, "teacher")
    _check_running_statistics(r["net"], state.batch_stats)
    assert r["teacher"].step == len(r["records"])


@pytest.mark.parametrize("disable_bn", [False, True])
def test_two_stage_tracks_spcl_tpu(disable_bn):
    r = _lockstep(128, "nhwc", 1, seed=3, two_stage=True, disable_bn=disable_bn)
    _check_metrics(*r["records"][0])
    _check_running_statistics(r["net"], r["state"].batch_stats)
    _check_parameters(r["net"], r["state"].params["model"], "student")
    bn = r["net"]._Conv1.conv[1]
    assert int(bn.num_batches_tracked) == (1 if disable_bn else 2)


@pytest.fixture(scope="module")
def aux_run():
    spec = MT_UDA + (("create_mixup_hook", {"weight": 0.5}),
                     ("create_uc_mt_hook", {"weight": 1.0, "threshold_begin": 0.9,
                                            "threshold_end": 0.9}))
    return _lockstep(128, "nhwc", 1, seed=4, spec=spec, scalars={"ucmt": {"threshold": 0.9}})


def test_mixup_branch_tracks_spcl_tpu(aux_run):
    jm, pm = aux_run["records"][0]
    _check_metrics(jm, pm)
    assert "mix_reg" in pm["hooks"]
    _check_parameters(aux_run["net"], aux_run["state"].params["model"], "student")
    _check_running_statistics(aux_run["net"], aux_run["state"].batch_stats)


def test_ucmt_tracks_spcl_tpu(aux_run):
    jm, pm = aux_run["records"][0]
    assert 0.0 < float(pm["hooks"]["ucmt"]["uc_ratio"]) <= 1.0
    np.testing.assert_allclose(float(pm["hooks"]["ucmt"]["uc_ratio"]),
                               float(jm["hooks"]["ucmt"]["uc_ratio"]), rtol=1e-4)
    _check_parameters(aux_run["teacher"].model, aux_run["state"].teacher_params, "teacher")


# ------------------------------------------------------------------ port only
def _port_step(layout, max_channel, spec, store=None, seed=0):
    torch.manual_seed(seed)
    _, _, _, net = _pair(max_channel, layout, seed)
    hooks = _hooks(creator, spec)
    opt = build_optimizer(list(net.parameters()), lr=LR, weight_decay=WD)
    teacher = EMATeacher(net)
    step = build_semi_step(net, hooks, opt, num_classes=4,
                           policy=dataclasses.replace(aug.ACDC_LABEL, crop=CROP),
                           teacher=teacher, store=store)
    return net, teacher, step


def test_device_data_equals_host_batches_to_the_bit():
    ds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    store = DeviceStore.for_dataset(ds, "cpu")
    rng = np.random.default_rng(3)
    spec = MT_UDA + (("create_mixup_hook", {"weight": 0.5}),)
    outs = {}
    for mode in ("device", "host"):
        net, teacher, step = _port_step("nhwc", 128, spec, store=store)
        gen = torch.Generator().manual_seed(5)
        rows = [(rng.choice(len(ds.images), 3, replace=False),
                 rng.choice(len(ds.images), 3, replace=False)) for _ in range(2)]
        rng = np.random.default_rng(3)
        ms = []
        for il, iu in rows:
            if mode == "device":
                ml = step(torch.as_tensor(il), torch.as_tensor(iu), gen, {})
            else:
                ml = step(batch_to_device(ds.batch(il), "cpu"),
                          batch_to_device(ds.batch(iu), "cpu"), gen, {})
            ms.append(ml)
        outs[mode] = (ms, net.state_dict(), teacher.state_dict()["model"])
    (md, sd, td), (mh, sh, th) = outs["device"], outs["host"]
    for a, b in zip(md, mh):
        for k in ("sup_loss", "reg_loss", "inter", "union"):
            assert torch.equal(a[k], b[k]), k
    for k in sd:
        assert torch.equal(sd[k], sh[k]) and torch.equal(td[k], th[k]), k


@pytest.mark.parametrize("layout,max_channel", [("nhwc", 128), ("pallas", 256)])
def test_teacher_and_auxiliary_forwards_leave_running_statistics(layout, max_channel):
    """One step with the teacher, mixup's student forward and UC-MT's noisy
    teacher passes moves the student's running statistics once (its main
    forward) and the teacher's never."""
    spec = MT_UDA + (("create_mixup_hook", {"weight": 0.5}),
                     ("create_uc_mt_hook", {"weight": 1.0}))
    net, teacher, step = _port_step(layout, max_channel, spec, seed=2)
    ds = synthetic_dataset("acdc", num_scans=2, canvas=CANVAS, seed=0)
    before = copy.deepcopy(teacher.model.state_dict())
    student_before = copy.deepcopy(net.state_dict())
    gen = torch.Generator().manual_seed(1)
    step(batch_to_device(ds.batch(np.arange(2)), "cpu"),
         batch_to_device(ds.batch(np.arange(2, 4)), "cpu"), gen, {"ucmt": {"threshold": 0.75}})
    for k, v in teacher.model.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, before[k]), k
    for k, v in net.state_dict().items():
        if "num_batches" in k:
            assert int(v) == int(student_before[k]) + 1, k
    # the teacher alone, in train mode under the layout, moves nothing either
    teacher.logits(torch.rand(2, 1, CROP, CROP))
    for k, v in teacher.model.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, before[k]), k
