"""Shared helpers of the tests/test_torch_*.py files: the random draws of
spcl_tpu's pretrain (with its decoder hooks' points), fine-tune, semi and
adversarial steps, replayed with the JAX package's own functions so that
spcl_torch can be handed the very same values."""
import jax
import numpy as np
import torch

from spcl_tpu.data import augment as jaug


def jax_view_draws(key, batch, policy, in_size, sizes=None, total_freedom=True):
    """The draws of `spcl_tpu.data.augment.augment_twice(key, ...)`
    (augment.py:406-417 and the jitter draws of :378-382), as the
    `sample_twice` dict spcl_torch's `augment_twice` takes."""
    kg1, kg2, kj1, kj2 = jax.random.split(key, 4)
    p1 = jaug.sample_geometric(kg1, batch, policy, in_size, sizes)
    p2 = jaug.sample_geometric(kg2, batch, policy, in_size, sizes) if total_freedom else p1
    out = {"geo1": to_torch(p1), "geo2": to_torch(p2)}
    if policy.jitter:
        for name, k in (("jitter1", kj1), ("jitter2", kj2)):
            kb, kc = jax.random.split(k)
            br = jax.random.uniform(kb, (batch, 1, 1, 1), minval=policy.brightness[0],
                                    maxval=policy.brightness[1])
            ct = jax.random.uniform(kc, (batch, 1, 1, 1), minval=policy.contrast[0],
                                    maxval=policy.contrast[1])
            out[name] = (to_torch(br).reshape(-1), to_torch(ct).reshape(-1))
    return out


def jax_step_draws(key, batch, policy, in_size, sizes=None, flip_threshold=0.8,
                   total_freedom=True, hooks=()):
    """The draws of spcl_tpu's pretrain step for `key` (steps.py:421-427):
    {"aug": ..., "flip": ...} for spcl_torch's step `params`, with
    {"hooks": {name: points}} for the decoder-stage InfoNCE hooks among the
    spcl_tpu `hooks` (`jax_dense_draws` from the step's hook key)."""
    k_aug, k_flip, k_hooks = jax.random.split(key, 3)
    out = {"aug": jax_view_draws(k_aug, batch, policy, in_size, sizes, total_freedom),
           "flip": to_torch(jaug.flip_params(k_flip, batch, threshold=flip_threshold))}
    dense = {h.name: jax_dense_draws(k_hooks, batch, h) for h in hooks if not h.is_encoder}
    if dense:
        out["hooks"] = dense
    return out


def jax_dense_draws(k_hooks, n, hook):
    """The points a decoder-stage InfoNCE hook of spcl_tpu draws from the
    step's hook key (hooks/infonce.py:162-165: fold_in(key, 17), one key for
    the rows and one for the columns of the pooled grid), as the
    {"ys", "xs"} [n, points] draws of spcl_torch's hook."""
    ky, kx = jax.random.split(jax.random.fold_in(k_hooks, 17))
    h, w = hook.spatial_size
    shape = (n, hook.num_sampled_points)
    return {"ys": to_torch(jax.random.randint(ky, shape, 0, h)),
            "xs": to_torch(jax.random.randint(kx, shape, 0, w))}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def nchw(x):
    x = np.asarray(x)
    return np.transpose(x, (0, 3, 1, 2)) if x.ndim == 4 else x


def jax_finetune_draws(key, batch, policy, in_size, sizes=None):
    """The draws of spcl_tpu's fine-tune step for `key` (steps.py:164 and
    augment.py:392-397 `augment_once`): {"aug": <sample_once dict>} for
    spcl_torch's step `params`."""
    k_aug, _ = jax.random.split(key)
    return {"aug": jax_once_draws(k_aug, batch, policy, in_size, sizes)}


def jax_semi_draws(key, n_l, n_u, policy, in_size, sizes_l=None, sizes_u=None,
                   mixup=False, flip_threshold=0.8, hooks=()):
    """The draws of spcl_tpu's semi step for `key` (steps.py:246-261, and the
    hooks' own draws from the hook key, hooks/ucmt.py:47-50 and
    hooks/mixup.py:29-31) as spcl_torch's semi step `params`. `hooks`:
    spcl_tpu hook objects whose draws to replay."""
    k_lab, k_unl, k_flip, k_hooks = jax.random.split(key, 4)
    lab = (jax_view_draws(k_lab, n_l, policy, in_size, sizes_l) if mixup
           else jax_once_draws(k_lab, n_l, policy, in_size, sizes_l))
    out = {"lab": lab,
           "unl": jax_view_draws(k_unl, n_u, policy, in_size, sizes_u, total_freedom=False),
           "flip": to_torch(jaug.flip_params(k_flip, n_u, threshold=flip_threshold)),
           "hooks": {}}
    crop = policy.crop
    for h in hooks:
        if h.name == "ucmt":
            keys = jax.random.split(jax.random.fold_in(k_hooks, 41), h.num_noise_samples)
            noise = np.stack([nchw(jax.random.normal(k, (n_u, crop, crop, 1))) for k in keys])
            out["hooks"][h.name] = {"noise": torch.from_numpy(noise)}
        elif h.name == "mix_reg":
            k_lam, k_perm = jax.random.split(jax.random.fold_in(k_hooks, 29))
            out["hooks"][h.name] = {
                "lam": torch.tensor(float(jax.random.beta(k_lam, h.alpha, h.alpha))),
                "perm": torch.from_numpy(np.array(jax.random.permutation(k_perm, 2 * n_l)))}
    return out


def jax_once_draws(key, batch, policy, in_size, sizes=None):
    """The draws of `spcl_tpu.data.augment.augment_once(key, ...)`
    (augment.py:389-398) as the `sample_once` dict spcl_torch's
    `augment_once` takes."""
    kg, kj = jax.random.split(key)
    out = {"geo": to_torch(jaug.sample_geometric(kg, batch, policy, in_size, sizes))}
    if policy.jitter:
        kb, kc = jax.random.split(kj)
        br = jax.random.uniform(kb, (batch, 1, 1, 1), minval=policy.brightness[0],
                                maxval=policy.brightness[1])
        ct = jax.random.uniform(kc, (batch, 1, 1, 1), minval=policy.contrast[0],
                                maxval=policy.contrast[1])
        out["jitter"] = (to_torch(br).reshape(-1), to_torch(ct).reshape(-1))
    return out


def jax_adversarial_draws(key, n_l, n_u, policy, in_size, sizes_l=None, sizes_u=None):
    """The draws of spcl_tpu's adversarial step for `key` (steps.py:514-519):
    {"lab": ..., "unl": ...} <sample_once dict>s for spcl_torch's step
    `params`."""
    k_l, k_u = jax.random.split(key)
    return {"lab": jax_once_draws(k_l, n_l, policy, in_size, sizes_l),
            "unl": jax_once_draws(k_u, n_u, policy, in_size, sizes_u)}
