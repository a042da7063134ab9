"""The summation order of convstage_poolsums (spcl_torch/ops/csrc/convstage.cu,
`poolsums_kernel` in float32, `poolsums_bf16_kernel` in bfloat16) modelled in
numpy on the CPU: the kernels have no CPU mode.

The model follows the kernels step by step: one lane per 16-byte chunk of a
row pair's upper row and the chunk below it (a pixel's 4 channels in float32,
8 in bfloat16); the window's two columns in lanes i and i ^ C/4 (float32) or
i ^ C/8 (bfloat16), which route dp to the first maximum in scan order
(float32: they exchange their column maxima and mask bits; bfloat16: each
element's key is its bf16-rounded e = relu(y) above 3 - its scan position,
and the pair exchanges the larger of each lane's two keys); chunks
round-robin over clusters x 8 blocks x 256 threads; float32 runs of at most
PS_RUN = 8 chunks (16 terms a channel) added to float64 (the bfloat16
kernel's loads ahead change no order); a shuffle butterfly over the lanes
that share channels (which the kernels run as a reduce-scatter, to the same
bits: `test_reduce_scatter_gives_the_butterfly_sums`), the 8 warps in order,
the 8 blocks of a cluster in rank order, and the clusters through a fixed
tree of K = 256 / 2C slots.

It holds (a) the routed and masked dy1 equal, element for element, to the
plain version's (`convstage_cuda._dy1`), ties included, and (b) the sums within
chip_smoke.py's STAGE_TOL (2e-4 x max|sum|) of float64 sums of the same dy1,
and of `poolsums_plain`, at the run lengths a thread has on an H100 and
beyond, and with more clusters than tree slots. At S1 = 60 x 224 x 224 x 16
in float32: 6,021,120 chunks over 45 resident clusters of 8 blocks, 66
chunks a thread (62 resident clusters and 48 chunks without de); in
bfloat16: 3,010,560 chunks over 45 resident clusters with de and without,
33 chunks a thread (`poolsums_plan` on the card).
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


# channels a lane owns (one 16-byte chunk of a pixel)
LANE_CHANNELS = {"float32": 4, "bfloat16": 8}


def _chunks(t, v):
    """[B, H, W, C] -> [chunks, 2, v]: chunk i = (row pair, pixel, v channels)
    of the upper row, with the chunk below it."""
    b, h, w, c = t.shape
    return t.reshape(b * h // 2, 2, w * c // v, v).transpose(0, 2, 1, 3).reshape(-1, 2, v)


def _unchunk(t, shape, v):
    b, h, w, c = shape
    return t.reshape(b * h // 2, w * c // v, 2, v).transpose(0, 2, 1, 3).reshape(shape)


def _bf16_bits(x):
    """The bits of float32 `x` rounded to bfloat16 (to nearest even), uint32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=F32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)


def model_dy(z1, coef, dp, de, dtype="float32"):
    """(dy1 of every chunk [chunks, 2, v], z1 chunks) as the lanes of the
    `dtype` kernel compute them; z1, dp, de hold values of that dtype."""
    b, h, w, c = z1.shape
    v = LANE_CHANNELS[dtype]
    lanes, wc = c // v, w * c // v                  # lanes of a pixel, of a pixel row
    z = _chunks(z1, v)
    i = np.arange(len(z))
    ch = i % lanes
    inv, sh = coef[0].reshape(lanes, v)[ch][:, None], coef[1].reshape(lanes, v)[ch][:, None]
    y = (z * inv).astype(F32) + sh                    # two roundings, as bn_apply
    dy = np.zeros_like(z) if de is None else _chunks(de, v).copy()
    if dp is not None:
        rp, rem = i // wc, i % wc
        g = dp.reshape(-1, v)[rp * (wc // 2) + (rem // (2 * lanes)) * lanes + ch]
        partner = i ^ lanes                           # the window's other column
        right = ((i // lanes) & 1).astype(bool)[:, None]
        if dtype == "bfloat16":
            # keys: e = relu of y rounded to bf16 (cvt.rn.relu, sign bit
            # cleared), its bits above 3 - the scan position (r0,c0) 0,
            # (r0,c1) 1, (r1,c0) 2, (r1,c1) 3
            bits = _bf16_bits(y)
            e = np.where((bits << 16).view(F32) > 0, bits, 0).astype(np.uint32)
            code = np.where(right[:, :, None], np.array([2, 0])[None, :, None],
                            np.array([3, 1])[None, :, None]).astype(np.uint32)
            key = e << 16 | code                      # [chunk, row, channel]
            mine = key.max(axis=1)
            m = np.maximum(mine, mine[partner])
            dy = dy + np.where(key == m[:, None], g[:, None], F32(0))
        else:
            e = np.maximum(y, F32(0))
            mine = e.max(axis=1)
            m = np.maximum(mine, mine[partner])
            bits = e == m[:, None]                    # [chunk, row, channel]
            left_b = np.where(right[:, None], bits[partner], bits)
            right_b = np.where(right[:, None], bits, bits[partner])
            first = np.where(left_b[:, 0], 0, np.where(right_b[:, 0], 1,
                                                        np.where(left_b[:, 1], 2, 3)))
            col = right.astype(int)
            dy[:, 0] += np.where(first == col, g, F32(0))
            dy[:, 1] += np.where(first == 2 + col, g, F32(0))
    return np.where(y >= 0, dy, F32(0)).astype(F32), z


def model_sums(dy, z, c, clusters, v=4):
    """(sum dy, sum dy*z) [2, C] float64 in the kernel's order, lanes of v
    channels."""
    lanes = c // v
    threads = clusters * CLUSTER * NT
    iters = -(-len(dy) // threads)
    pad = iters * threads - len(dy)
    dy = np.concatenate([dy, np.zeros((pad, 2, v), F32)]).reshape(iters, threads, 2, v)
    z = np.concatenate([z, np.zeros((pad, 2, v), F32)]).reshape(iters, threads, 2, v)
    f0, f1 = np.zeros((threads, v), F32), np.zeros((threads, v), F32)
    d0, d1 = np.zeros((threads, v)), np.zeros((threads, v))
    for k in range(iters):
        for r in range(2):
            f0 = f0 + dy[k, :, r]
            f1 = _fmaf(dy[k, :, r], z[k, :, r], f1)
        if (k + 1) % RUN == 0 or k == iters - 1:
            d0, d1 = d0 + f0, d1 + f1
            f0, f1 = np.zeros_like(f0), np.zeros_like(f1)
    s = np.concatenate([d0, d1], axis=1).reshape(-1, WARP, 2 * v)  # [warps, lane, (s0|s1) x v]
    lane = np.arange(WARP)
    off = WARP // 2
    while off >= lanes:                               # the butterfly
        s = s + s[:, lane ^ off]
        off //= 2
    # lane l < C/v holds channels v*l..v*l+v-1: -> [warps, 2, C]
    s = s[:, :lanes].reshape(-1, lanes, 2, v).transpose(0, 2, 1, 3).reshape(-1, 2 * c)
    warps = s.reshape(-1, NT // WARP, 2 * c)
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


def _inputs(seed, b, h, w, c, ties=False, dtype="float32"):
    """z1, coef, dp, de as float32 arrays holding values of `dtype`, and the
    same as torch tensors of `dtype` (coef float32)."""
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((b, h, w, c)).astype(F32)
    coef = np.stack([1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)]).astype(F32)
    if ties:  # few distinct values and BN the identity: equal maxima in most windows
        z1 = (np.round(z1 * 2) / 2).astype(F32)
        coef = np.stack([np.ones(c), np.zeros(c)]).astype(F32)
    dp = rng.standard_normal((b, h // 2, w // 2, c)).astype(F32)
    de = rng.standard_normal((b, h, w, c)).astype(F32)
    tdtype = getattr(torch, dtype)
    tensors = [torch.from_numpy(t).to(tdtype) for t in (z1, dp, de)]
    arrays = [t.float().numpy() for t in tensors]
    return ((arrays[0], coef, arrays[1], arrays[2]),
            (tensors[0], torch.from_numpy(coef), tensors[1], tensors[2]))


DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
CASES = [
    # (b, h, w, c, clusters): S1's image at 2 clusters (float32 49 chunks a
    # thread, bfloat16 25) and 1 (98, 49), around S1's on the card
    (2, 224, 224, 16, 2), (2, 224, 224, 16, 1),
    (1, 112, 112, 32, 1),                 # S2's image, C32: 25 (13) chunks a thread
    (3, 20, 36, 32, 1),                   # small odd batch: most threads idle
    (4, 64, 64, 16, 11),                  # more clusters than the 8 tree slots of C16
]


@DTYPES
@pytest.mark.parametrize("cotangents", ["dp and de", "de absent", "dp absent"])
@pytest.mark.parametrize("b,h,w,c,clusters", CASES)
def test_poolsums_order_holds_against_float64(b, h, w, c, clusters, cotangents, dtype):
    arrays, tensors = _inputs(b + h + c + clusters, b, h, w, c, dtype=dtype)
    z1, coef, dp, de = arrays
    absent = {"dp absent": 2, "de absent": 3}.get(cotangents)
    if absent is not None:
        arrays = arrays[:absent] + (None,) + arrays[absent + 1:]
        tensors = tensors[:absent] + (None,) + tensors[absent + 1:]
    v = LANE_CHANNELS[dtype]
    dy, z = model_dy(*arrays, dtype=dtype)
    plain_dy = cs._dy1(*tensors).numpy()
    np.testing.assert_array_equal(_unchunk(dy, z1.shape, v), plain_dy)
    got = model_sums(dy, z, c, clusters, v)
    d64 = plain_dy.astype(np.float64)
    exact = np.stack([d64.sum(axis=(0, 1, 2)), (d64 * z1).sum(axis=(0, 1, 2))])
    plain = cs.poolsums_plain(*tensors).numpy()
    for want in (exact, plain):
        assert np.abs(got - want).max() <= STAGE_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype,ties", [("float32", "quantised"), ("bfloat16", "quantised"),
                                        ("bfloat16", "rounded")])
def test_poolsums_routing_with_ties_matches_plain(dtype, ties):
    """Equal maxima in most windows: the pair's bits (float32) or keys
    (bfloat16) route dp to the first one in scan order, as the plain version
    does. "quantised": few distinct z1 and BN the identity, so equal y;
    "rounded": y = 0.01 z1 + 4 of normal z1, distinct in float32, most of a
    window's one value once rounded to bfloat16 (its step at 4 is 2^-5)."""
    (z1, coef, dp, _), (tz1, _, tdp, _) = _inputs(5, 2, 16, 24, 32, ties=ties == "quantised",
                                                  dtype=dtype)
    if ties == "rounded":
        coef = np.stack([np.full(32, 0.01), np.full(32, 4.0)]).astype(F32)
    tcoef = torch.from_numpy(coef)
    dy, _ = model_dy(z1, coef, dp, None, dtype=dtype)
    plain = cs._dy1(tz1, tcoef, tdp, None).numpy()
    np.testing.assert_array_equal(_unchunk(dy, z1.shape, LANE_CHANNELS[dtype]), plain)
    e = torch.relu(cs._bn(tz1, tcoef)).to(tz1.dtype)
    windows = cs._windows(e)
    maxima = (windows == windows.amax(dim=3, keepdim=True)).sum(dim=3)
    assert int((maxima > 1).sum()) > maxima.numel() // 8   # ties are common here
    if ties == "rounded":  # ... and nearly all come from the rounding (equal bf16 z1: few)
        y = cs._windows(cs._bn(tz1, tcoef))
        assert int(((y == y.amax(dim=3, keepdim=True)).sum(dim=3) > 1).sum()) \
            < maxima.numel() // 50


def _butterfly(vals, lanes):
    """[32, 2v] float64 lane values -> [2C]: the butterfly over the lane bits
    above `lanes`, read from lanes 0 .. lanes - 1 (lane l: channels l*v ..)."""
    v = vals.shape[1] // 2
    off = WARP // 2
    while off >= lanes:
        vals = vals + vals[np.arange(WARP) ^ off]
        off //= 2
    return np.concatenate([vals[:lanes, :v].reshape(-1), vals[:lanes, v:].reshape(-1)])


def _reduce_scatter(vals, lanes):
    """The same sums as `poolsums_combine` forms them: at each lane bit a lane
    keeps half of its values (the upper half where the bit is set) and adds
    its partner's values of that half; lane l's value t is then value at + t
    of its channels, stored at [sum dy | sum dy*z] index (l % lanes) * v + j."""
    v = vals.shape[1] // 2
    c = lanes * v
    vals, at = vals.copy(), np.zeros(WARP, dtype=int)
    lane = np.arange(WARP)
    off, n = WARP // 2, 2 * v
    while off >= lanes:
        upper = (lane & off) != 0
        lo, hi = vals[:, :n // 2], vals[:, n // 2:n]
        keep, give = np.where(upper[:, None], hi, lo), np.where(upper[:, None], lo, hi)
        vals = keep + give[lane ^ off]
        at += np.where(upper, n // 2, 0)
        off, n = off // 2, n // 2
    out = np.full(2 * c, np.nan)
    for ln in range(WARP):
        for t in range(c // 16):
            j = at[ln] + t
            out[(0 if j < v else c - v) + (ln % lanes) * v + j] = vals[ln, t]
    return out


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_gives_the_butterfly_sums(c, dtype):
    """The kernels' reduce-scatter over the lanes that share channels adds
    every sum in the butterfly's pairs (a + b == b + a in float64): the same
    bits, every sum written once."""
    v = LANE_CHANNELS[dtype]
    vals = np.random.default_rng(c + v).standard_normal((WARP, 2 * v)) * 1e3
    np.testing.assert_array_equal(_reduce_scatter(vals, c // v), _butterfly(vals, c // v))
