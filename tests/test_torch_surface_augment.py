"""Cutout and Sobel in spcl_torch against spcl_tpu, on the CPU.

- `apply_cutout`: spcl_tpu's box / yc / xc for a key, drawn with its own
  three `jax.random` calls, are handed to the port; the output is bit-equal
  in float32 and bf16, for several shapes and box ranges up to min(H, W),
  and a non-zero fill. The port's own draws (`sample_cutout`) keep the box in
  [min_box, max_box] and the square inside the image (hypothesis).
- `sobel_process`: within 1e-6 of max|g|, with and without
  `include_origin`, for one and three channels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spcl_tpu.data import augment as jaug
from spcl_torch.data import augment as taug
from torch_port_helpers import nchw


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cutout_draws(key, b, h, w, min_box, max_box):
    """The draws of spcl_tpu's `apply_cutout(key, ...)` (augment.py:476-482)."""
    kb, ky, kx = jax.random.split(key, 3)
    box = jax.random.randint(kb, (b,), min_box, max_box + 1)
    half = jnp.floor(box / 2.0).astype(jnp.int32)
    yc = half + jnp.floor(jax.random.uniform(ky, (b,)) * (h - 2 * half)).astype(jnp.int32)
    xc = half + jnp.floor(jax.random.uniform(kx, (b,)) * (w - 2 * half)).astype(jnp.int32)
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("box", box), ("yc", yc), ("xc", xc))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,w,min_box,max_box,pad", [
    (4, 1, 32, 32, 6, 10, 0.0),
    (3, 3, 17, 23, 1, 17, 0.25),     # boxes up to min(H, W), odd sizes
    (5, 2, 24, 16, 16, 16, -1.0),    # one box size, the whole width
    (2, 1, 9, 9, 0, 9, 0.5),         # box 0 erases nothing
])
def test_cutout_bit_equal_given_spcl_tpu_draws(dtype, b, c, h, w, min_box, max_box, pad):
    key = jax.random.PRNGKey(h * 100 + w)
    x = np.random.default_rng(h + w).random((b, h, w, c)).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jaug.apply_cutout(key, jnp.asarray(x, jdtype), min_box, max_box, pad_value=pad)
    want = nchw(np.asarray(want.astype(jnp.float32)))
    params = _jax_cutout_draws(key, b, h, w, min_box, max_box)
    image = torch.from_numpy(nchw(x).copy()).to(tdtype)
    got = taug.apply_cutout(image, params, pad_value=pad)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if max_box >= 2:
        assert (got != image).any()  # some box erased something


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 4), h=st.integers(1, 40), w=st.integers(1, 40),
       lo=st.floats(0, 1), hi=st.floats(0, 1), seed=st.integers(0, 2**31 - 1))
def test_sample_cutout_boxes_stay_inside(b, h, w, lo, hi, seed):
    side = min(h, w)
    min_box = int(lo * side)
    max_box = min_box + int(hi * (side - min_box))
    gen = torch.Generator().manual_seed(seed)
    p = taug.sample_cutout(gen, b, h, w, min_box, max_box)
    assert ((p["box"] >= min_box) & (p["box"] <= max_box)).all()
    half = p["box"] // 2
    for centre, side_len in ((p["yc"], h), (p["xc"], w)):
        assert ((centre - half >= 0) & (centre + half <= side_len)).all()
    out = taug.apply_cutout(torch.ones(b, 2, h, w), p)
    erased = (out == 0).sum(dim=(2, 3))
    assert torch.equal(erased, (4 * half * half).reshape(-1, 1).expand(b, 2))


def test_sample_cutout_refuses_boxes_larger_than_the_image():
    with pytest.raises(ValueError):
        taug.sample_cutout(torch.Generator(), 2, 16, 12, 4, 13)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("include_origin", [False, True])
def test_sobel_matches_spcl_tpu(c, include_origin):
    rng = np.random.default_rng(c)
    x = rng.random((3, 21, 26, c)).astype(np.float32)
    x[:, :, 13:] += 1.0  # a vertical edge
    want = nchw(np.asarray(jaug.sobel_process(jnp.asarray(x), include_origin=include_origin)))
    got = taug.sobel_process(torch.from_numpy(nchw(x).copy()), include_origin=include_origin)
    assert got.shape == (3, 2 + (c if include_origin else 0), 21, 26)
    got = got.numpy()
    scale = np.abs(want[:, :2]).max()
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-6 * scale
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
