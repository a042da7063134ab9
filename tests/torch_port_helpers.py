"""Shared helpers of the tests/test_torch_port_*.py files: the random draws of
spcl_tpu's pretrain step, replayed with the JAX package's own functions so
that spcl_torch can be handed the very same values."""
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


def jax_step_draws(key, batch, policy, in_size, sizes=None, flip_threshold=0.8):
    """The draws of spcl_tpu's pretrain step for `key` (steps.py:421-427):
    {"aug": ..., "flip": ...} for spcl_torch's step `params`."""
    k_aug, k_flip, _ = jax.random.split(key, 3)
    return {"aug": jax_view_draws(k_aug, batch, policy, in_size, sizes),
            "flip": to_torch(jaug.flip_params(k_flip, batch, threshold=flip_threshold))}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def nchw(x):
    x = np.asarray(x)
    return np.transpose(x, (0, 3, 1, 2)) if x.ndim == 4 else x
