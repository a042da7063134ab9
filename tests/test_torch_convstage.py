"""spcl_torch's fused small-channel encoder stage against spcl_tpu's
`fused_packed_block`, on the CPU.

The same numpy arrays go through both packages. spcl_tpu runs its Pallas
kernels in interpret mode (as tests/test_experimental_packed.py does); the
port runs the plain versions of its CUDA kernels, which a CPU tensor takes.

- The stage alone at B=2, H=8, W=16, 16->16 and 16->32 channels, with
  `external_first` both ways: p, e and the four batch statistics (rtol 1e-4,
  atol 1e-5) and every gradient under random cotangents of p and e (rtol
  2e-3, atol 2e-4) — the tolerances of the JAX package's own test.
- The UNet in train mode under `small_c_layout="pallas"` at max_channel 256,
  32x32 input, batch 4, from transplanted weights: every activation (rtol
  and atol 1e-3, the train-mode tolerance of tests/test_torch_port_model.py)
  and the running statistics after one forward, which spcl_tpu's `pallas`
  path updates with the biased batch variance.
- Dispatch: eval mode and unpackable shapes take the plain path; `packable`
  agrees with spcl_tpu's; the state_dict keys do not depend on the layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.experimental.packed_block_pallas import fused_packed_block
from spcl_tpu.experimental.packed_stage import pack, packable as jax_packable, unpack
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_torch.entry import build_model_from_config
from spcl_torch.experimental.packed_stage import packable, run_conv_stage
from spcl_torch.models import UNet, unet_state_dict_from_flax
from spcl_torch.ops import convstage_cuda as cs
from test_torch_port_model import random_flax_unet

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def _stage_arrays(external_first, c_in, c_out, b=2, h=8, w=16):
    rng = np.random.RandomState(0 if external_first else 1)
    cw = c_out if external_first else c_in
    f32 = np.float32
    return dict(
        x=rng.randn(b, h, w, cw).astype(f32),
        w0=(rng.randn(3, 3, cw, c_out) * 0.2).astype(f32),
        w1=(rng.randn(3, 3, c_out, c_out) * 0.2).astype(f32),
        g0=(1.0 + 0.1 * rng.randn(c_out)).astype(f32), b0=(0.1 * rng.randn(c_out)).astype(f32),
        g1=(1.0 + 0.1 * rng.randn(c_out)).astype(f32), b1=(0.1 * rng.randn(c_out)).astype(f32),
        cp=rng.randn(b, h // 2, w // 2, c_out).astype(f32),
        ce=rng.randn(b, h, w, c_out).astype(f32))


@pytest.mark.parametrize("external_first", [True, False])
@pytest.mark.parametrize("c_in,c_out", [(16, 16), (16, 32)], ids=["same16", "expand16to32"])
def test_stage_matches_fused_packed_block(external_first, c_in, c_out):
    check_stage_against_fused_packed_block(external_first, c_in, c_out)


def check_stage_against_fused_packed_block(external_first, c_in, c_out):
    """`cs.fused_conv_stage` on CPU tensors (whatever passes `cs._PLAIN_PASSES`
    holds) against spcl_tpu's `fused_packed_block` in interpret mode:
    outputs at FWD_TOL, every gradient at GRAD_TOL."""
    a = _stage_arrays(external_first, c_in, c_out)
    cw = a["x"].shape[3]
    names = ("x", "w0", "g0", "b0", "w1", "g1", "b1")

    # ---- spcl_tpu: packed, padded input; Pallas in interpret mode
    xpad = jnp.pad(pack(jnp.asarray(a["x"])), ((0, 0), (1, 1), (1, 1), (0, 0)))
    jargs = (xpad,) + tuple(jnp.asarray(a[k]) for k in names[1:])

    def jloss(*args):
        out = fused_packed_block(*args, cw, c_out, "float32", external_first)
        return (jnp.sum(unpack(out[0], c_out) * a["cp"])
                + jnp.sum(unpack(out[1], c_out) * a["ce"])), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(7)), has_aux=True)(*jargs)
    want = [np.asarray(unpack(jout[0], c_out)), np.asarray(unpack(jout[1], c_out))] \
        + [np.asarray(v) for v in jout[2:]]
    want_grads = dict(zip(names, (np.asarray(g) for g in jgrads)))
    want_grads["x"] = np.asarray(unpack(jgrads[0][:, 1:-1, 1:-1, :], cw))

    # ---- spcl_torch: channels-last input; the plain passes behind the Function
    targs = {k: _t(a[k], grad=True) for k in names}
    out = cs.fused_conv_stage(*(targs[k] for k in names), external_first=external_first)
    for name, got, ref in zip(("p", "e", "mean0", "var0", "mean1", "var1"), out, want):
        np.testing.assert_allclose(got.detach().numpy(), ref, err_msg=name, **FWD_TOL)
    assert not any(t.requires_grad for t in out[2:])  # statistics carry no gradient
    ((out[0] * _t(a["cp"])).sum() + (out[1] * _t(a["ce"])).sum()).backward()
    for name in names:
        if external_first and name == "w0":
            assert targs[name].grad is None  # unused in the external path
            continue
        np.testing.assert_allclose(targs[name].grad.numpy(), want_grads[name],
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("missing", ["de", "dp"])
def test_stage_backward_with_one_cotangent_absent(missing):
    """A stage whose e (or p) nobody consumes gets no cotangent for it; the
    backward then equals the one with a zero cotangent."""
    a = _stage_arrays(False, 16, 32)
    names = ("x", "w0", "g0", "b0", "w1", "g1", "b1")

    def grads(zero_fill):
        targs = [_t(a[k], grad=True) for k in names]
        p, e = cs.fused_conv_stage(*targs)[:2]
        used, other = (p, e) if missing == "de" else (e, p)
        cot = _t(a["cp"] if missing == "de" else a["ce"])
        loss = (used * cot).sum()
        if zero_fill:
            loss = loss + (other * 0.0).sum()
        loss.backward()
        return [t.grad.numpy() for t in targs]

    for name, g_none, g_zero in zip(names, grads(False), grads(True)):
        np.testing.assert_allclose(g_none, g_zero, rtol=1e-6, atol=1e-6, err_msg=name)


def test_pool_backward_goes_to_first_maximum():
    """All-equal windows (as after a ReLU of negatives): dp lands on the
    window's first pixel in scan order, and the mask y >= 0 keeps y == 0."""
    z1 = torch.zeros(1, 4, 4, 16)
    coef = torch.stack([torch.ones(16), torch.zeros(16)])
    dp = torch.arange(1.0, 5.0).reshape(1, 2, 2, 1).expand(1, 2, 2, 16).contiguous()
    dy = cs._dy1(z1, coef, dp, None)
    want = torch.zeros(1, 4, 4, 16)
    want[0, 0::2, 0::2, :] = dp[0]
    assert torch.equal(dy, want)
    # strictly negative y is masked out even where the pool routes to it
    assert float(cs._dy1(z1 - 1.0, coef, dp, None).abs().max()) == 0.0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: handed a CPU tensor they raise
    before any build or launch (the dispatch on `is_cuda` lives above them)."""
    z = torch.zeros(1, 4, 4, 16)
    coef = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cs.bnpool_kernel(z, coef)
    with pytest.raises(ValueError, match="CUDA"):
        cs.conv_kernel(z, torch.zeros(3, 3, 16, 16))
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert cs.passes_for(z) is cs._PLAIN_PASSES


@pytest.mark.parametrize("w", [16, 30, 32, 48, 224, 256])
@pytest.mark.parametrize("c1,c2", [(8, 16), (16, 32), (24, 48), (32, 64)])
def test_packable_agrees_with_spcl_tpu(w, c1, c2):
    assert packable(w, c1, c2) == jax_packable(w, c1, c2)


# ------------------------------------------------------------------ the UNet under `pallas`
@pytest.fixture(scope="module")
def pallas_nets():
    rng = np.random.default_rng(3)
    params, stats = random_flax_unet(rng, max_channel=256)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=256, small_c_layout="pallas")
    net = UNet(input_dim=1, num_classes=4, max_channel=256, small_c_layout="pallas")
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in unet_state_dict_from_flax(params, stats).items()},
                        strict=True)
    x = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    jacts, mut = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        acts = net(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    return dict(jacts=jacts, new_stats=mut["batch_stats"], acts=acts, net=net, x=x,
                params=params, stats=stats)


def test_unet_pallas_train_activations_match(pallas_nets):
    s = pallas_nets
    assert set(s["acts"]) == set(s["jacts"])
    for name, want in s["jacts"].items():
        got = s["acts"][name].numpy()
        np.testing.assert_allclose(got, np.transpose(np.asarray(want), (0, 3, 1, 2)),
                                   err_msg=name, **TRAIN_TOL)
    assert s["acts"]["Conv1"].shape == (4, 16, 32, 32)   # NCHW views
    assert s["acts"]["Conv2"].shape == (4, 32, 16, 16)


def test_unet_pallas_running_statistics_match(pallas_nets):
    """The fused stages update the running variance with the biased batch
    variance (spcl_tpu's `_BNVars`); the other stages use the unbiased one."""
    s = pallas_nets
    for stage in ("Conv1", "Conv2", "Conv3", "Up_conv2"):
        block = s["net"].stage(stage).conv
        for i, bn in enumerate((block[1], block[4])):
            want = s["new_stats"][stage][f"bn{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{stage} bn{i} mean")
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{stage} bn{i} var")
    # and it is the biased variance: on the plain path Conv1's differs
    plain = UNet(max_channel=256)
    plain.load_state_dict({k: torch.from_numpy(v) for k, v in unet_state_dict_from_flax(
        s["params"], s["stats"]).items()})
    plain.train()
    with torch.no_grad():
        plain(torch.from_numpy(np.transpose(s["x"], (0, 3, 1, 2)).copy()))
    n = 4 * 32 * 32
    fused_var = s["net"]._Conv1.conv[1].running_var
    old = torch.from_numpy(np.asarray(s["stats"]["Conv1"]["bn0"]["var"]))
    batch_var_biased = (fused_var - 0.9 * old) / 0.1
    np.testing.assert_allclose(plain._Conv1.conv[1].running_var.numpy(),
                               (0.9 * old + 0.1 * batch_var_biased * n / (n - 1)).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_flax_pallas_tree_loads_strictly_and_keys_are_layout_free():
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=256, small_c_layout="pallas")
    variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 1)), train=False)
    net = UNet(max_channel=256, small_c_layout="pallas")
    sd = unet_state_dict_from_flax(variables["params"], variables["batch_stats"])
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    assert list(net.state_dict()) == list(UNet(max_channel=256).state_dict())
    assert sum(p.numel() for p in net.parameters()) \
        == sum(p.numel() for p in UNet(max_channel=256).parameters())


def test_eval_mode_and_odd_shapes_take_the_plain_path(monkeypatch):
    calls = []
    import spcl_torch.models.unet as unet_mod
    monkeypatch.setattr(unet_mod, "run_conv_stage",
                        lambda *a, **k: calls.append(1) or run_conv_stage(*a, **k))
    torch.manual_seed(0)
    net = UNet(max_channel=256, small_c_layout="pallas")
    plain = UNet(max_channel=256)
    plain.load_state_dict(net.state_dict())
    x = torch.randn(2, 1, 32, 32)
    net.eval(), plain.eval()
    with torch.no_grad():
        assert torch.equal(net(x)["logits"], plain(x)["logits"])
        assert not calls                       # eval: plain path
        net.train(), plain.train()
        odd = torch.randn(2, 1, 24, 24)        # 24/2 * 16 is no multiple of 128
        assert torch.equal(net(odd, until="Conv3")["Conv3"],
                           plain(odd, until="Conv3")["Conv3"])
        assert not calls                       # unpackable: plain path
        net(x, until="Conv2")
        assert len(calls) == 2                 # train + packable: both fused stages


def test_config_passes_the_layout_through():
    assert build_model_from_config({"Arch": {"small_c_layout": "pallas"}}).small_c_layout \
        == "pallas"
    assert build_model_from_config({"Arch": {}}).small_c_layout == "nhwc"
    assert build_model_from_config({"Arch": {"small_c_layout": "packed"}}).small_c_layout \
        == "packed"
    with pytest.raises(ValueError):
        UNet(small_c_layout="lanes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["conv", "bnconv", "dwprev", "dwdx"])
def test_float64_pass_agrees_with_the_plain_version(name, dtype):
    """`float64_pass`, the float64 reference of the kernels' accuracy
    measurements, computes what the plain version computes, on the same
    operands: outputs stored in the activations' dtype within their rounding
    (2^-8 x max|ref| for bf16, 1e-5 for float32), float32 outputs (weight
    gradients, sums) within 1e-5 x max|ref|, float32 arithmetic on 288-term
    products being all that differs."""
    check_float64_pass(name, dtype, 16, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["conv", "dwdx"])
@pytest.mark.parametrize("ci,c", [(16, 16), (32, 32)])
def test_float64_pass_agrees_with_the_plain_version_at_each_width(ci, c, name, dtype):
    """The same for conv and dwdx at the widths the kernels take beside
    16 -> 32 (the test above): 16 -> 16 and 32 -> 32."""
    check_float64_pass(name, dtype, ci, c)


def check_float64_pass(name, dtype, ci, c):
    """`float64_pass` against the plain pass `name` on [2, 10, 12] activations
    of ci (x) and c channels (the rest) in `dtype`, at the tolerances of
    `test_float64_pass_agrees_with_the_plain_version`."""
    g = torch.Generator().manual_seed(3)
    b, h, w = 2, 10, 12

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    act = {n: rn(b, h, w, ci if n == "x" else c).to(dtype) for n in ("x", "z0", "dz1", "dy0")}
    coef = torch.stack([1 + rn(c, scale=0.1), rn(c, scale=0.1)])
    dcoef = torch.stack([1 + rn(c, scale=0.1), rn(c, scale=0.01), rn(c, scale=0.01)])
    w0, w1 = rn(3, 3, ci, c, scale=1 / 12), rn(3, 3, c, c, scale=1 / 12)
    inputs = {"conv": (act["x"], w0), "bnconv": (act["z0"], coef, w1),
              "dwprev": (act["dz1"], act["z0"], coef, w1),
              "dwdx": (act["z0"], act["dy0"], dcoef, act["x"], w0)}[name]
    want = cs.float64_pass(name, *inputs)
    got = cs._PLAIN_PASSES[name](*inputs)
    for x, ref in zip(got, want):
        assert ref.dtype == torch.float64
        tol = 2.0 ** -8 if x.dtype == torch.bfloat16 else 1e-5
        assert float((x.double() - ref).abs().max()) <= tol * float(ref.abs().max())
