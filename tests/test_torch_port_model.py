"""spcl_torch's UNet, BatchNorm, projection head and stage masking against
spcl_tpu's, with weights carried across by spcl_torch.models.transplant.

Small size: max_channel=128 (the smallest the JAX UNet takes), 32x32 input,
batch 4. Activations are compared after transposing the JAX package's NHWC
to NCHW. Tolerance: float32 convolutions summed in another order through up
to 19 conv layers — rtol 1e-4, atol 1e-4 on eval activations and logits;
1e-5 on the projection head. Train mode 1e-3: spcl_tpu's BatchNorm takes the
one-pass E[x^2] - mean^2 variance, torch a two-pass one, and at Conv5 a
channel holds only 16 values here, so normalizing amplifies that rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.models.heads import ProjectionHead as JaxHead
from spcl_tpu.models.masking import stages_from_range as jax_stages_from_range
from spcl_tpu.models.torch_import import (flax_from_torch_state_dict,
                                          torch_state_dict_from_flax)
from spcl_tpu.models.unet import LAYER_DIMENSION, UNet as JaxUNet, stages_up_to
from spcl_torch.models import (ProjectionHead, UNet, head_state_dict_from_flax,
                               set_trainable_stages, stages_from_range,
                               unet_state_dict_from_flax)

TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)
MAXC = 128


def _nchw(x):
    x = np.asarray(x)
    return np.transpose(x, (0, 3, 1, 2)) if x.ndim == 4 else x


def random_flax_unet(rng, max_channel=MAXC):
    """A flax UNet variable tree drawn with numpy: He-scaled conv kernels,
    random BN affine and running statistics (so eval parity exercises
    them), in spcl_tpu's layout via its own torch_import converter."""
    sd = {}
    for k, v in UNet(max_channel=max_channel).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            sd[k] = rng.normal(0.0, 0.3, shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif len(shape) == 1:  # BN weight
            sd[k] = rng.normal(1.0, 0.2, shape).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[k] = (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return flax_from_torch_state_dict(sd)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 1), dtype=np.float32)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC)
    params, stats = random_flax_unet(rng)
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    sd = unet_state_dict_from_flax(params, stats)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jacts = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    return dict(x=x, jnet=jnet, params=params, stats=stats, net=net,
                jacts={k: _nchw(v) for k, v in jacts.items()})


def test_state_dict_keys_are_the_reference_keys(nets):
    """The port's UNet state_dict keys == the reference torch UNet's, as
    spcl_tpu's exporter writes them."""
    ref = torch_state_dict_from_flax(nets["params"], nets["stats"])
    assert set(nets["net"].state_dict()) == set(ref)
    for k, v in unet_state_dict_from_flax(nets["params"], nets["stats"]).items():
        np.testing.assert_array_equal(v, ref[k])


def test_eval_logits_and_every_stage_match(nets):
    net = nets["net"].eval()
    with torch.no_grad():
        acts = net(torch.from_numpy(_nchw(nets["x"])))
    assert set(acts) == set(nets["jacts"])
    for k, v in acts.items():
        np.testing.assert_allclose(v.numpy(), nets["jacts"][k], **TOL, err_msg=k)


@pytest.mark.parametrize("until", list(LAYER_DIMENSION))
def test_until_stops_at_the_stage(nets, until):
    net = nets["net"].eval()
    with torch.no_grad():
        acts = net(torch.from_numpy(_nchw(nets["x"])), until=until)
    assert [k for k in acts if k != "logits"] == list(stages_up_to(until))
    np.testing.assert_allclose(acts[until].numpy(), nets["jacts"][until], **TOL)


def test_jax_until_matches_port_until(nets):
    """JAX's own early exit at Conv5 (the pretrain forward) against the port's."""
    jacts = nets["jnet"].apply({"params": nets["params"], "batch_stats": nets["stats"]},
                               jnp.asarray(nets["x"]), train=False, until="Conv5")
    with torch.no_grad():
        acts = nets["net"].eval()(torch.from_numpy(_nchw(nets["x"])), until="Conv5")
    np.testing.assert_allclose(acts["Conv5"].numpy(), _nchw(jacts["Conv5"]), **TOL)


def test_train_mode_outputs_and_running_stats_match(nets):
    """Train mode normalizes with batch statistics and updates the running
    statistics with the unbiased variance, momentum 0.1 (torch convention)."""
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict(nets["net"].state_dict())
    net.train()
    x = nets["x"]
    acts = net(torch.from_numpy(_nchw(x)))
    jacts, mut = nets["jnet"].apply({"params": nets["params"], "batch_stats": nets["stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
    for k in ("Conv5", "logits"):
        np.testing.assert_allclose(acts[k].detach().numpy(), _nchw(jacts[k]), **TRAIN_TOL,
                                   err_msg=k)
    new_stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    want = unet_state_dict_from_flax(nets["params"], new_stats)
    got = net.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v, **TRAIN_TOL, err_msg=k)


@pytest.mark.parametrize("spatial", [(1, 1), (2, 2)])
def test_projection_head_matches(spatial):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(6, 4, 4, 32)).astype(np.float32)
    jhead = JaxHead(output_dim=16, hidden_dim=24, spatial_size=spatial)
    variables = jhead.init(jax.random.PRNGKey(2), jnp.asarray(feats))
    head = ProjectionHead(input_dim=32, output_dim=16, hidden_dim=24, spatial_size=spatial)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_state_dict_from_flax(variables).items()},
                         strict=True)
    with torch.no_grad():
        z = head(torch.from_numpy(_nchw(feats)))
    ref = np.asarray(jhead.apply(variables, jnp.asarray(feats)))
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(z.numpy(), axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("rng_args", [(None, "Conv5"), ("Conv5", "Up_conv3"), (None, None),
                                      ("Up5", "Deconv_1x1")])
def test_stages_from_range_matches(rng_args):
    assert stages_from_range(*rng_args) == jax_stages_from_range(*rng_args)


def test_frozen_stages_take_no_gradient():
    net = UNet(max_channel=MAXC)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    for name, p in net.named_parameters():
        encoder = name.split(".")[0] in ("_Conv1", "_Conv2", "_Conv3", "_Conv4", "_Conv5")
        assert p.requires_grad == encoder, name
