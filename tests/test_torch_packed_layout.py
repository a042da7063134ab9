"""`Arch.small_c_layout: packed` in spcl_torch against spcl_tpu's packed UNet,
on the CPU.

spcl_tpu's `packed` layout runs Conv1 and Conv2 as lane-packed stages
(`experimental/packed_stage.py::PackedConvStage`) whose BatchNorm,
`_PackedBN`, is not the plain path's: its running variance takes the biased
batch variance, and it applies x * inv + shift with inv and shift rounded to
the activations' dtype. The port computes that function with PyTorch's ops
(`CrossRankBatchNorm2d.packed`). The same numpy weights (spcl_tpu's tree,
carried across by the transplant) and inputs go through both UNets at
max_channel 128 (c1 = 8, c2 = 16; spcl_tpu's smallest) on 2 x 32 x 32,
which `packable` accepts:

- two train steps (softmax cross-entropy on random labels, SGD lr 0.05) in
  lockstep: the first step's activations and logits within `ACT_TOL`
  relative L2 of spcl_tpu's, its loss within `LOSS_TOL`, every parameter's
  gradient within `GRAD_TOL` relative L2;
- the running statistics after the two steps within `STAT_TOL`
  (elementwise, relative to the move the two batches made), a tolerance
  under which Bessel's factor (n = 2048 values a channel at Conv1, 512 at
  Conv2) fails: the test checks that the unbiased update would miss it;
  Conv1/Conv2's running variances stand to the plain path's in Bessel's
  ratio, Conv3's equal them;
- eval logits after those steps (running statistics through `_PackedBN`'s
  apply at Conv1 / Conv2) within `EVAL_TOL`, and the plain path's logits
  from the same steps more than ten times further off (3.2e-4: they differ
  through Conv1/Conv2's running variances);
- a width `packable` refuses (48, the effect study's crop) takes the plain
  path in both packages: each package's `packed` equals its own `nhwc`;
- bfloat16: the train-mode activations to Conv3 within test_torch_bf16's
  `UNET_TOL` and a quarter of spcl_tpu's own bf16-vs-float32 gap (measured
  0: equal to the bit; spcl_tpu's gap 6.5e-3 to 2.4e-2); `packed_conv`
  alone against spcl_tpu's `packed_conv` at 8 -> 8, 8 -> 16 and 16 -> 16
  channels within `PCONV_TOL` (measured 0), where the plain bf16
  convolution, which rounds once, misses by 3.2e-3 (and the UNet's Conv1
  by 3.9e-3).

Torch runs on one thread (module fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spcl_tpu.experimental.packed_stage import pack, packable as jax_packable, unpack
from spcl_tpu.experimental.packed_stage import packed_conv as jax_packed_conv
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_torch.entry import build_model_from_config
from spcl_torch.models import UNet, unet_state_dict_from_flax
from spcl_torch.models.packed_layout import packed_conv
from test_torch_bf16 import ROUND_EVERY_OP, UNET_TOL, _hold
from test_torch_port_model import random_flax_unet

MAXC, B, HW, LR = 128, 2, 32, 0.05
ACT_TOL = 1e-4    # relative L2, train mode (measured up to 7.7e-6, step 2's logits)
LOSS_TOL = 1e-6   # relative (measured 2.6e-7)
GRAD_TOL = 2e-4   # relative L2 (measured up to 1.7e-5)
STAT_TOL = 1e-5   # elementwise, relative to the batches' share (measured up to 1.2e-6)
EVAL_TOL = 1e-5   # relative L2, eval logits (measured 7.4e-7)
PCONV_TOL = 1e-3  # relative L2, bf16 packed_conv (measured 0; the plain conv 3.2e-3)
STAGES = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5", "Up_conv5", "Up_conv2", "logits")
BF16 = torch.bfloat16


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


def _nchw(a) -> np.ndarray:
    return np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))


def _torch_sd(params, stats) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            unet_state_dict_from_flax(params, stats).items()}


def _jax_loss(net):
    def loss(params, stats, x, labels):
        acts, new = net.apply({"params": params, "batch_stats": stats}, x, train=True,
                              mutable=["batch_stats"])
        logp = jax.nn.log_softmax(acts["logits"].astype(jnp.float32), axis=-1)
        ce = -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))
        return ce, (acts, new["batch_stats"])
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_step(net, x, labels):
    """One train step of the port's UNet: (loss, activations, gradients by
    state_dict key); the SGD update applied."""
    net.train()
    net.zero_grad()
    acts = net(x)
    loss = F.cross_entropy(acts["logits"], labels)
    loss.backward()
    loss = float(loss.detach())
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    with torch.no_grad():
        for p in net.parameters():
            p -= LR * p.grad
    return loss, {k: v.detach().float() for k, v in acts.items()}, grads


@pytest.fixture(scope="module")
def lockstep():
    """Both packages through two train steps under `packed` from the same
    weights and batches, then an eval forward; the port also under `nhwc`."""
    rng = np.random.default_rng(17)
    params, stats = random_flax_unet(rng, max_channel=MAXC)
    xs = [rng.normal(size=(B, HW, HW, 1)).astype(np.float32) for _ in range(2)]
    labels = [rng.integers(0, 4, size=(B, HW, HW)) for _ in range(2)]
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC, small_c_layout="packed")
    step = _jax_loss(jnet)
    out = {"params0": params, "stats0": stats, "jax": [], "torch": [], "nhwc": []}
    jp, js = params, stats
    for x, y in zip(xs, labels):
        (loss, (acts, js_new)), g = step(jp, js, jnp.asarray(x), jnp.asarray(y))
        out["jax"].append(dict(loss=float(loss), acts={k: _nchw(v) for k, v in acts.items()},
                               grads=unet_state_dict_from_flax(g, js)))
        jp = jax.tree_util.tree_map(lambda p, d: p - LR * d, jp, g)
        js = js_new
    out["jax_stats"] = js
    xe = rng.normal(size=(B, HW, HW, 1)).astype(np.float32)
    out["jax_eval"] = _nchw(jnet.apply({"params": jp, "batch_stats": js}, jnp.asarray(xe),
                                       train=False)["logits"])
    for layout in ("packed", "nhwc"):
        net = UNet(max_channel=MAXC, small_c_layout=layout)
        net.load_state_dict(_torch_sd(params, stats), strict=True)
        for x, y in zip(xs, labels):
            loss, acts, grads = _torch_step(net, torch.from_numpy(_nchw(x)),
                                            torch.from_numpy(y))
            out["torch" if layout == "packed" else "nhwc"].append(
                dict(loss=loss, acts=acts, grads=grads))
        net.eval()
        with torch.no_grad():
            out[f"{layout}_eval"] = net(torch.from_numpy(_nchw(xe)))["logits"].numpy()
        out[f"{layout}_net"] = net
    return out


def test_the_shape_is_packable_in_both_packages():
    assert jax_packable(HW, MAXC // 16, MAXC // 8)
    assert UNet(max_channel=MAXC, small_c_layout="packed")._packable(torch.zeros(B, 1, HW, HW))


@pytest.mark.parametrize("step", [0, 1])
def test_train_activations_and_loss_match(lockstep, step):
    want, got = lockstep["jax"][step], lockstep["torch"][step]
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    for name in STAGES:
        err = _rel(got["acts"][name].numpy(), want["acts"][name])
        assert err <= ACT_TOL, (name, err)


@pytest.mark.parametrize("step", [0, 1])
def test_every_gradient_matches(lockstep, step):
    want, got = lockstep["jax"][step]["grads"], lockstep["torch"][step]["grads"]
    assert set(got) <= set(want)
    for key, g in got.items():
        err = _rel(g.numpy(), want[key])
        assert err <= GRAD_TOL, (key, err)


def _running(net, stage, i):
    bn = net.stage(stage).conv[1 + 3 * i]
    return bn.running_mean.numpy().astype(np.float64), bn.running_var.numpy().astype(np.float64)


def test_running_statistics_are_packed_stages_biased_ones(lockstep):
    """After two steps r = 0.81 r0 + 0.09 v1 + 0.1 v2: the port's equal
    spcl_tpu's within STAT_TOL of the batches' share r - 0.81 r0; with
    Bessel's factor on v1, v2 (the plain path's update) Conv1 and Conv2 would
    miss by (n/(n-1) - 1) = 4.9e-4 and 2.0e-3 of it."""
    net, js, s0 = lockstep["packed_net"], lockstep["jax_stats"], lockstep["stats0"]
    for stage in ("Conv1", "Conv2", "Conv3", "Conv5", "Up_conv2"):
        for i in (0, 1):
            jm = np.asarray(js[stage][f"bn{i}"]["mean"], np.float64)
            jv = np.asarray(js[stage][f"bn{i}"]["var"], np.float64)
            v0 = np.asarray(s0[stage][f"bn{i}"]["var"], np.float64)
            m0 = np.asarray(s0[stage][f"bn{i}"]["mean"], np.float64)
            tm, tv = _running(net, stage, i)
            share_v, share_m = jv - 0.81 * v0, jm - 0.81 * m0
            scale_v = np.abs(share_v).max()
            assert np.abs(tv - jv).max() <= STAT_TOL * scale_v, (stage, i, "var")
            assert np.abs(tm - jm).max() <= STAT_TOL * max(np.abs(share_m).max(), 1e-3), \
                (stage, i, "mean")
            if stage in ("Conv1", "Conv2"):
                n = B * HW * HW // (1 if stage == "Conv1" else 4)
                unbiased = 0.81 * v0 + share_v * n / (n - 1)
                assert np.abs(unbiased - jv).max() > 10 * STAT_TOL * scale_v, (stage, i)


def test_running_variances_stand_in_bessels_ratio_to_the_plain_path(lockstep):
    """Port against port, one step's update: packed's Conv1/Conv2 batch share
    times n/(n-1) is nhwc's; Conv3's (plain in both) is the same. Both runs
    start from the same weights, so the first step sees the same batch."""
    s0 = lockstep["stats0"]
    packed, plain = UNet(max_channel=MAXC, small_c_layout="packed"), UNet(max_channel=MAXC)
    x = torch.from_numpy(_nchw(np.random.default_rng(5).normal(size=(B, HW, HW, 1))))
    for net in (packed, plain):
        net.load_state_dict(_torch_sd(lockstep["params0"], s0), strict=True)
        net.train()
        with torch.no_grad():
            net(x)
    for stage, n in (("Conv1", B * HW * HW), ("Conv2", B * HW * HW // 4),
                     ("Conv3", None)):
        for i in (0, 1):
            v0 = np.asarray(s0[stage][f"bn{i}"]["var"], np.float64)
            share_p = _running(packed, stage, i)[1] - 0.9 * v0
            share_n = _running(plain, stage, i)[1] - 0.9 * v0
            want = share_p * (n / (n - 1)) if n else share_p
            np.testing.assert_allclose(share_n, want, rtol=STAT_TOL, atol=0,
                                       err_msg=f"{stage} bn{i}")


def test_eval_logits_after_the_steps_match(lockstep):
    err = _rel(lockstep["packed_eval"], lockstep["jax_eval"])
    assert err <= EVAL_TOL, err
    # and they are not the plain path's: Conv1/Conv2 normalise through
    # `_PackedBN`'s running statistics
    assert _rel(lockstep["nhwc_eval"], lockstep["jax_eval"]) > 10 * EVAL_TOL


def test_a_width_packable_refuses_takes_the_plain_path_in_both_packages():
    hw = 48
    assert not jax_packable(hw, MAXC // 16, MAXC // 8)
    rng = np.random.default_rng(29)
    params, stats = random_flax_unet(rng, max_channel=MAXC)
    x = rng.normal(size=(B, hw, hw, 1)).astype(np.float32)
    jax_out = {}
    for layout in ("packed", "nhwc"):
        jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC, small_c_layout=layout)
        acts, new = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=True, until="Conv2", mutable=["batch_stats"])
        jax_out[layout] = (acts, new["batch_stats"])
    for name in ("Conv1", "Conv2"):
        np.testing.assert_array_equal(np.asarray(jax_out["packed"][0][name]),
                                      np.asarray(jax_out["nhwc"][0][name]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_out["packed"][1],
                           jax_out["nhwc"][1])
    nets = {}
    for layout in ("packed", "nhwc"):
        nets[layout] = UNet(max_channel=MAXC, small_c_layout=layout)
        nets[layout].load_state_dict(_torch_sd(params, stats), strict=True)
    xt = torch.from_numpy(_nchw(x))
    for train in (True, False):
        outs = {}
        for layout, net in nets.items():
            net.train(train)
            with torch.no_grad():
                outs[layout] = net(xt, until="Conv2")
        for name in ("Conv1", "Conv2"):
            assert torch.equal(outs["packed"][name], outs["nhwc"][name]), (train, name)
    for a, b in zip(nets["packed"].buffers(), nets["nhwc"].buffers()):
        assert torch.equal(a, b)


def test_config_builds_the_packed_unet():
    net = build_model_from_config({"Arch": {"small_c_layout": "packed", "max_channel": MAXC}})
    assert net.small_c_layout == "packed"
    assert list(net.state_dict()) == list(UNet(max_channel=MAXC).state_dict())


def test_bf16_train_activations_match(lockstep):
    """bf16 under `packed`: Conv1 / Conv2 round inv and shift to bf16 and
    apply x * inv + shift (spcl_tpu's rounding points), against spcl_tpu's
    packed bf16 UNet jitted with every bf16 operation rounded."""
    params, stats = lockstep["params0"], lockstep["stats0"]
    x = np.random.default_rng(31).normal(size=(B, HW, HW, 1)).astype(np.float32)
    want = {}
    for dtype in ("bfloat16", "float32"):
        jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC, small_c_layout="packed",
                       dtype=jnp.dtype(dtype))

        def fwd(p, s, xin):
            acts, _ = jnet.apply({"params": p, "batch_stats": s}, xin, train=True,
                                 until="Conv3", mutable=["batch_stats"])
            return {k: v.astype(jnp.float32) for k, v in acts.items()}

        args = (params, stats, jnp.asarray(x))
        acts = jax.jit(fwd).lower(*args).compile(compiler_options=ROUND_EVERY_OP)(*args)
        want[dtype] = {k: _nchw(v) for k, v in acts.items()}
    net = UNet(max_channel=MAXC, small_c_layout="packed", dtype=BF16)
    net.load_state_dict(_torch_sd(params, stats), strict=True)
    net.train()
    with torch.no_grad():
        acts = net(torch.from_numpy(_nchw(x)), until="Conv3")
    for name, got in acts.items():
        assert got.dtype == BF16, name
        _hold(name, got.float().numpy(), want["bfloat16"][name], want["float32"][name],
              UNET_TOL)


@pytest.mark.parametrize("ci,co,w", [(8, 8, 32), (8, 16, 16), (16, 16, 16)])
def test_bf16_packed_conv_rounds_where_spcl_tpus_does(ci, co, w):
    rng = np.random.default_rng(ci + co)
    x = rng.normal(size=(2, 6, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    fn = jax.jit(lambda a, k: unpack(jax_packed_conv(pack(a), k, dtype=jnp.bfloat16), co))
    want = _nchw(fn.lower(xb, jnp.asarray(wt)).compile(compiler_options=ROUND_EVERY_OP)(
        xb, jnp.asarray(wt)).astype(jnp.float32))
    xt = torch.from_numpy(_nchw(x)).to(BF16)
    weight = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()
    got = packed_conv(xt, weight)
    assert got.dtype == BF16
    assert _rel(got.float().numpy(), want) <= PCONV_TOL
    plain = F.conv2d(xt, weight.to(BF16), padding=1).float().numpy()
    assert _rel(plain, want) > 2 * PCONV_TOL
    f32 = packed_conv(torch.from_numpy(_nchw(x)), weight)
    assert torch.equal(f32, F.conv2d(torch.from_numpy(_nchw(x)), weight, padding=1))
