"""The summation order of convstage_poolsums (spcl_torch/ops/csrc/convstage.cu,
`poolsums_kernel`) modelled in numpy on the CPU: the kernel has no CPU mode.

The model follows the kernel step by step: one lane per 16-byte chunk (a
pixel's 4 channels) of a row pair's upper row and the chunk below it; the
window's two columns in lanes i and i ^ C/4, which exchange their column
maxima and mask bits to route dp to the first maximum in scan order; chunks
round-robin over clusters x 8 blocks x 256 threads; float32 runs of at most
PS_RUN = 8 chunks (16 terms a channel) added to float64; a shuffle butterfly
over the lanes that share channels, the 8 warps in order, the 8 blocks of a
cluster in rank order, and the clusters through a fixed tree of K = 256 / 2C
slots.

It holds (a) the routed and masked dy1 equal, element for element, to the
plain version's (`convstage_cuda._dy1`), ties included, and (b) the sums within
chip_smoke.py's STAGE_TOL (2e-4 x max|sum|) of float64 sums of the same dy1,
and of `poolsums_plain`, at the run lengths a thread has at S1 = 60 x 224 x
224 x 16 on an H100 (6,021,120 chunks over 45 resident clusters of 8 blocks:
66 chunks a thread; 62 resident clusters and 48 chunks without de) and
beyond, and with more clusters than tree slots.
"""
import numpy as np
import pytest
import torch

from spcl_torch.ops import convstage_cuda as cs

NT, CLUSTER, RUN, WARP = 256, 8, 8, 32   # the kernel's constants
STAGE_TOL = 2e-4
F32 = np.float32


def _fmaf(a, b, c):
    """float32 fma: the exact product plus c, rounded once (float64 holds a
    product of two float32 exactly)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _chunks(t, c4):
    """[B, H, W, C] -> [chunks, 2, 4]: chunk i = (row pair, pixel, 4 channels)
    of the upper row, with the chunk below it."""
    b, h, w, c = t.shape
    return t.reshape(b * h // 2, 2, w * c4, 4).transpose(0, 2, 1, 3).reshape(-1, 2, 4)


def _unchunk(t, shape):
    b, h, w, c = shape
    return t.reshape(b * h // 2, w * c // 4, 2, 4).transpose(0, 2, 1, 3).reshape(shape)


def model_dy(z1, coef, dp, de):
    """(dy1 of every chunk [chunks, 2, 4], z1 chunks) as the lanes compute them."""
    b, h, w, c = z1.shape
    c4, wc4 = c // 4, w * c // 4
    z = _chunks(z1, c4)
    i = np.arange(len(z))
    ch = i % c4
    inv, sh = coef[0].reshape(c4, 4)[ch][:, None], coef[1].reshape(c4, 4)[ch][:, None]
    y = (z * inv).astype(F32) + sh                    # two roundings, as bn_apply
    dy = np.zeros_like(z) if de is None else _chunks(de, c4).copy()
    if dp is not None:
        rp, rem = i // wc4, i % wc4
        g = dp.reshape(-1, 4)[rp * (wc4 // 2) + (rem // (2 * c4)) * c4 + ch]
        e = np.maximum(y, F32(0))
        partner = i ^ c4                              # the window's other column
        mine = e.max(axis=1)
        m = np.maximum(mine, mine[partner])
        bits = e == m[:, None]                        # [chunk, row, channel]
        right = ((i // c4) & 1).astype(bool)[:, None]
        left_b = np.where(right[:, None], bits[partner], bits)
        right_b = np.where(right[:, None], bits, bits[partner])
        first = np.where(left_b[:, 0], 0, np.where(right_b[:, 0], 1,
                                                    np.where(left_b[:, 1], 2, 3)))
        col = right.astype(int)
        dy[:, 0] += np.where(first == col, g, F32(0))
        dy[:, 1] += np.where(first == 2 + col, g, F32(0))
    return np.where(y >= 0, dy, F32(0)).astype(F32), z


def model_sums(dy, z, c, clusters):
    """(sum dy, sum dy*z) [2, C] float64 in the kernel's order."""
    c4 = c // 4
    threads = clusters * CLUSTER * NT
    iters = -(-len(dy) // threads)
    pad = iters * threads - len(dy)
    dy = np.concatenate([dy, np.zeros((pad, 2, 4), F32)]).reshape(iters, threads, 2, 4)
    z = np.concatenate([z, np.zeros((pad, 2, 4), F32)]).reshape(iters, threads, 2, 4)
    f0, f1 = np.zeros((threads, 4), F32), np.zeros((threads, 4), F32)
    d0, d1 = np.zeros((threads, 4)), np.zeros((threads, 4))
    for k in range(iters):
        for r in range(2):
            f0 = f0 + dy[k, :, r]
            f1 = _fmaf(dy[k, :, r], z[k, :, r], f1)
        if (k + 1) % RUN == 0 or k == iters - 1:
            d0, d1 = d0 + f0, d1 + f1
            f0, f1 = np.zeros_like(f0), np.zeros_like(f1)
    v = np.concatenate([d0, d1], axis=1).reshape(-1, WARP, 8)   # [warps, lane, (s0|s1) x 4]
    lane = np.arange(WARP)
    off = WARP // 2
    while off >= c4:                                  # the butterfly
        v = v + v[:, lane ^ off]
        off //= 2
    # lane l < C/4 holds channels 4l..4l+3: -> [warps, 2, C]
    v = v[:, :c4].reshape(-1, c4, 2, 4).transpose(0, 2, 1, 3).reshape(-1, 2 * c)
    warps = v.reshape(-1, NT // WARP, 2 * c)
    block = warps[:, 0]
    for w in range(1, NT // WARP):
        block = block + warps[:, w]
    per_cluster = block.reshape(clusters, CLUSTER, 2 * c)
    part = per_cluster[:, 0]
    for rank in range(1, CLUSTER):
        part = part + per_cluster[:, rank]
    slots = NT // (2 * c)
    tree = np.zeros((slots, 2 * c))
    for s in range(slots):
        for p in range(s, clusters, slots):
            tree[s] = tree[s] + part[p]
    total = tree[0]
    for s in range(1, slots):
        total = total + tree[s]
    return total.reshape(2, c)


def _inputs(seed, b, h, w, c, ties=False):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((b, h, w, c)).astype(F32)
    coef = np.stack([1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)]).astype(F32)
    if ties:  # few distinct values and BN the identity: equal maxima in most windows
        z1 = (np.round(z1 * 2) / 2).astype(F32)
        coef = np.stack([np.ones(c), np.zeros(c)]).astype(F32)
    dp = rng.standard_normal((b, h // 2, w // 2, c)).astype(F32)
    de = rng.standard_normal((b, h, w, c)).astype(F32)
    return z1, coef, dp, de


CASES = [
    # (b, h, w, c, clusters): S1's image at 2 clusters (49 chunks a thread) and
    # 1 (98), around S1's 66 on the card
    (2, 224, 224, 16, 2), (2, 224, 224, 16, 1),
    (1, 112, 112, 32, 1),                 # S2's image, C32: 25 chunks a thread
    (3, 20, 36, 32, 1),                   # small odd batch: most threads idle
    (4, 64, 64, 16, 11),                  # more clusters than the 8 tree slots of C16
]


@pytest.mark.parametrize("cotangents", ["dp and de", "de absent", "dp absent"])
@pytest.mark.parametrize("b,h,w,c,clusters", CASES)
def test_poolsums_order_holds_against_float64(b, h, w, c, clusters, cotangents):
    z1, coef, dp, de = _inputs(b + h + c + clusters, b, h, w, c)
    dp = None if cotangents == "dp absent" else dp
    de = None if cotangents == "de absent" else de
    dy, z = model_dy(z1, coef, dp, de)
    as_t = [None if t is None else torch.from_numpy(t) for t in (z1, coef, dp, de)]
    plain_dy = cs._dy1(*as_t).numpy()
    np.testing.assert_array_equal(_unchunk(dy, z1.shape), plain_dy)
    got = model_sums(dy, z, c, clusters)
    d64 = plain_dy.astype(np.float64)
    exact = np.stack([d64.sum(axis=(0, 1, 2)), (d64 * z1).sum(axis=(0, 1, 2))])
    plain = cs.poolsums_plain(*as_t).numpy()
    for want in (exact, plain):
        assert np.abs(got - want).max() <= STAGE_TOL * np.abs(want).max()


def test_poolsums_routing_with_ties_matches_plain():
    """Quantised activations give equal maxima in most windows: the pair's
    bits route dp to the first one in scan order, as the plain version does."""
    z1, coef, dp, de = _inputs(5, 2, 16, 24, 32, ties=True)
    dy, _ = model_dy(z1, coef, dp, None)
    plain = cs._dy1(*(torch.from_numpy(t) for t in (z1, coef, dp)), None).numpy()
    np.testing.assert_array_equal(_unchunk(dy, z1.shape), plain)
    windows = cs._windows(torch.from_numpy(np.maximum(z1, 0)))
    maxima = (windows == windows.amax(dim=3, keepdim=True)).sum(dim=3)
    assert int((maxima > 1).sum()) > maxima.numel() // 8   # ties are common here
