"""Every hook of the semi-supervised path — consistency, mean teacher,
entropy minimisation, UC-MT, discrete MI (encoder and decoder stage), MIDL,
MINE and mixup — against spcl_tpu's on one shared ctx built from numpy, on
the CPU: the weighted loss, every metric, and the gradient of the loss with
respect to the student's tensors in the ctx.

The ctx holds what the semi step hands the hooks (spcl_tpu hooks/base.py:
21-35), NHWC for spcl_tpu and NCHW for the port: random logits, features,
images, one-hots, a `valid` vector with a padded row, flips, and student /
teacher forwards that are fixed elementwise maps of the images (so both
packages compute the same function). The hooks' random draws are
spcl_tpu's own (its keys, folded as its hooks fold them) injected into the
port as `ctx["draws"]`; projector weights are spcl_tpu's `build` output,
transplanted.

Tolerance: rtol 1e-5, atol 1e-6 on losses and metrics, 1e-5 / 1e-6 on
gradients (float32 reductions in another order); the hooks with a head or
a statistics net 1e-4 / 1e-5 (flax's one-pass GroupNorm variance, matmuls
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.hooks import creator as jcreator
from spcl_torch.hooks import creator
from spcl_torch.models import UNet, head_state_dict_from_flax

N_L, N, C, H = 4, 3, 4, 8           # labeled rows, unlabeled rows, classes, side
FEATS = {"Conv5": (2, 128), "Up_conv3": (8, 16)}  # side, channels at max_channel 128
KEY = jax.random.PRNGKey(5)
TOL = dict(rtol=1e-5, atol=1e-6)
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its CPU ops are small, and the
    suite runs test files side by side in several processes, where spinning
    intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    x = np.asarray(x)
    return np.ascontiguousarray(np.moveaxis(x, -1, 1)) if x.ndim == 4 else x


def _arrays():
    rng = np.random.default_rng(0)
    a = {"unlabeled_tf_logits": rng.normal(size=(N, H, H, C)) * 2,
         "unlabeled_logits_tf": rng.normal(size=(N, H, H, C)) * 2,
         "teacher_logits_tf": rng.normal(size=(N, H, H, C)) * 2,
         "unlabeled_image": rng.uniform(size=(N, H, H, 1)),
         "unlabeled_image_tf": rng.uniform(size=(N, H, H, 1)),
         "labeled_image": rng.uniform(size=(N_L, H, H, 1)),
         "labeled_image_tf": rng.uniform(size=(N_L, H, H, 1)),
         "labeled_onehot": np.eye(C)[rng.integers(0, C, (N_L, H, H))],
         "labeled_onehot_tf": np.eye(C)[rng.integers(0, C, (N_L, H, H))],
         "valid": np.array([1.0, 1.0, 0.0]),
         "fh": np.array([True, False, True]), "fv": np.array([False, True, True]),
         # the student / teacher "networks": logits = image * w + b per class
         "student_wb": rng.normal(size=(2, C)), "teacher_wb": rng.normal(size=(2, C))}
    for stage, (side, ch) in FEATS.items():
        a[stage] = rng.normal(size=(N_L + 2 * N, side, side, ch))
    return {k: v if v.dtype == bool else v.astype(np.float32) for k, v in a.items()}


def _jax_ctx(a, key):
    def net(wb):
        w, b = jnp.asarray(wb[0]), jnp.asarray(wb[1])
        return lambda img: img * w + b

    ctx = {k: jnp.asarray(a[k]) for k in ("unlabeled_tf_logits", "unlabeled_logits_tf",
                                          "teacher_logits_tf", "unlabeled_image",
                                          "unlabeled_image_tf", "labeled_image",
                                          "labeled_image_tf", "labeled_onehot",
                                          "labeled_onehot_tf", "valid")}
    ctx.update(acts={s: jnp.asarray(a[s]) for s in FEATS}, n_unl=N, num_classes=C, key=key,
               flip={"fh": jnp.asarray(a["fh"]), "fv": jnp.asarray(a["fv"])},
               apply_student=net(a["student_wb"]), apply_teacher=net(a["teacher_wb"]))
    return ctx


def _port_ctx(a):
    def net(wb):
        w = torch.from_numpy(wb[0]).reshape(1, C, 1, 1)
        b = torch.from_numpy(wb[1]).reshape(1, C, 1, 1)
        return lambda img: img * w + b

    ctx = {k: torch.tensor(_nchw(a[k]), requires_grad=k.endswith("logits") or
                           k.endswith("logits_tf"))
           for k in ("unlabeled_tf_logits", "unlabeled_logits_tf", "teacher_logits_tf",
                     "unlabeled_image", "unlabeled_image_tf", "labeled_image",
                     "labeled_image_tf", "labeled_onehot", "labeled_onehot_tf", "valid")}
    ctx["teacher_logits_tf"].requires_grad_(False)
    ctx.update(acts={s: torch.tensor(_nchw(a[s]), requires_grad=True) for s in FEATS},
               n_unl=N, num_classes=C,
               flip={"fh": torch.from_numpy(a["fh"]), "fv": torch.from_numpy(a["fv"])},
               apply_student=net(a["student_wb"]), apply_teacher=net(a["teacher_wb"]))
    return ctx


def _jax_draws(hook, key, a):
    """The draws spcl_tpu's hook makes inside its loss_fn, for the port."""
    if hook.name == "ucmt":  # hooks/ucmt.py:47-50
        keys = jax.random.split(jax.random.fold_in(key, 41), hook.num_noise_samples)
        noise = np.stack([_nchw(jax.random.normal(k, a["unlabeled_image"].shape))
                          for k in keys])
        return {"noise": torch.from_numpy(noise)}
    if hook.name == "mix_reg":  # hooks/mixup.py:29-31
        k_lam, k_perm = jax.random.split(jax.random.fold_in(key, 29))
        return {"lam": torch.tensor(float(jax.random.beta(k_lam, 1.0, 1.0))),
                "perm": torch.from_numpy(np.array(jax.random.permutation(k_perm, 2 * N_L)))}
    return None


# (factory, kwargs, scalars, tolerance)
CASES = {
    "consistency": ("create_consistency_hook", {"weight": 5.0}, {}, TOL),
    "mt": ("create_mt_hook", {"weight": 10.0}, {}, TOL),
    "entmin": ("create_ent_min_hook", {"weight": 0.1}, {}, TOL),
    "ucmt": ("create_uc_mt_hook", {"weight": 1.0, "threshold_begin": 0.6,
                                   "threshold_end": 0.9, "max_epoch": 10},
             {"threshold": 0.8}, TOL),
    "discreteMI/conv5": ("create_discrete_mi_consistency_hook",
                         {"feature_names": ["Conv5", "Up_conv3"], "mi_weights": [0.1, 0.05],
                          "dense_paddings": 2, "num_clusters": 6, "num_subheads": 3},
                         {}, HEAD_TOL),
    "discreteMI/up_conv3": ("create_discrete_mi_consistency_hook",
                            {"feature_names": ["Conv5", "Up_conv3"], "mi_weights": [0.1, 0.05],
                             "dense_paddings": 2, "num_clusters": 6, "num_subheads": 3},
                            {}, HEAD_TOL),
    "midl": ("create_midl_hook", {"iic_weight": 0.1, "padding": 2, "patch_size": 6}, {}, TOL),
    "mine/Conv5": ("create_mine_hooks", {"feature_names": "Conv5", "weights": 0.1}, {},
                   HEAD_TOL),
    "mix_reg": ("create_mixup_hook", {"weight": 0.01}, {}, TOL),
}


def _pick(hooks, name):
    from spcl_tpu.hooks.base import get_individual_hooks as jflat
    from spcl_torch.hooks.base import get_individual_hooks as flat
    out = [h for h in (jflat(hooks) if "spcl_tpu" in type(hooks).__module__ else flat(hooks))
           if h.name == name]
    assert len(out) == 1, name
    return out[0]


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.mark.parametrize("name", list(CASES))
def test_hook_matches_spcl_tpu(arrays, name):
    factory, kwargs, scalars, tol = CASES[name]
    made_j = getattr(jcreator, factory)(**kwargs)
    made_p = getattr(creator, factory)(**kwargs)
    jhook, hook = _pick(made_j, name), _pick(made_p, name)
    assert type(hook).__name__ == type(jhook).__name__ and hook.weight == jhook.weight
    assert hook.needs_teacher == jhook.needs_teacher

    jctx = _jax_ctx(arrays, KEY)
    jparams = jhook.build(jax.random.PRNGKey(1), None, jctx["acts"])
    hook.build(UNet(max_channel=128), "cpu")
    if jparams is not None:
        hook.projector.load_state_dict(
            {k: torch.from_numpy(v) for k, v in head_state_dict_from_flax(jparams).items()},
            strict=True)

    ctx = _port_ctx(arrays)
    ctx["draws"] = {hook.name: _jax_draws(jhook, KEY, arrays)}
    loss, metrics = hook.loss_fn(ctx, scalars)

    grad_keys = ["unlabeled_tf_logits", "unlabeled_logits_tf"]
    feature = getattr(jhook, "feature_name", None)

    def jloss(tf_logits, logits_tf, feats):
        c = dict(jctx, unlabeled_tf_logits=tf_logits, unlabeled_logits_tf=logits_tf)
        if feature is not None:
            c["acts"] = dict(jctx["acts"], **{feature: feats})
        return jhook.loss_fn(jparams, c, scalars)

    jargs = (jctx["unlabeled_tf_logits"], jctx["unlabeled_logits_tf"],
             jctx["acts"][feature] if feature else jnp.zeros(()))
    (jl, jm), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                  has_aux=True))(*jargs)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **tol)
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **tol, err_msg=k)

    if loss.requires_grad:  # mixup reads none of these tensors
        loss.backward()
    pairs = [(ctx[k].grad, jgrads[i]) for i, k in enumerate(grad_keys)]
    if feature is not None:
        pairs.append((ctx["acts"][feature].grad, jgrads[2]))
    for got, want in pairs:
        want = _nchw(want)
        if got is None:  # the hook's loss does not depend on this tensor
            assert not np.any(want)
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=tol["rtol"],
                                   atol=max(tol["atol"], 1e-6 * float(np.abs(want).max())))


def test_ucmt_schedule_and_state(arrays):
    hook = creator.create_uc_mt_hook(threshold_begin=0.5, threshold_end=0.9, max_epoch=4)
    jhook = jcreator.create_uc_mt_hook(threshold_begin=0.5, threshold_end=0.9, max_epoch=4)
    for epoch in range(6):
        assert hook.epoch_scalars(epoch) == jhook.epoch_scalars(epoch)
        hook.on_epoch_end()
        jhook.on_epoch_end()
    assert hook.state_dict() == jhook.state_dict()


def test_hook_draws_have_the_shapes_of_spcl_tpus(arrays):
    ctx = _port_ctx(arrays)
    g = torch.Generator().manual_seed(0)
    ucmt = creator.create_uc_mt_hook()
    assert ucmt.sample(g, ctx)["noise"].shape == (8, N, 1, H, H)
    mix = creator.create_mixup_hook()
    d = mix.sample(g, ctx)
    assert d["lam"].shape == () and 0.0 <= float(d["lam"]) <= 1.0
    assert sorted(d["perm"].tolist()) == list(range(2 * N_L))
    d = type(mix)(alpha=0.4).sample(g, ctx)  # Beta(0.4, 0.4): spcl_tpu's jax.random.beta
    assert d["lam"].shape == () and 0.0 <= float(d["lam"]) <= 1.0
    with pytest.raises(ValueError):
        type(mix)(alpha=0.0)
