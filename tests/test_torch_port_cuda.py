"""spcl_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `gpu`: skipped where torch sees no CUDA device
(the kernels have no CPU mode). On the GPU machine, without jax installed:

    python -m pytest --noconftest -p no:cacheprovider -m "gpu and not slow" tests/test_torch_port_cuda.py

(`-m "gpu and slow"` runs the effect study on the card, 15-25 minutes.)

Tolerance: 2e-4 absolute on the per-row statistics (rowloss, c, log denom,
a — all O(1..10)) and on the loss; 2e-4 x max|dz| on dz. float32 sums run in
another order, the products in 3xTF32 (float32 accuracy), and s carries
1/T = 14.3x the dot-product rounding. The
stage kernels of `convstage_cuda`: 2e-4 x max|plain| on every tensor; their
bf16 instantiation: 2^-7 x max|plain| on the bf16-stored tensors (one
rounding apart where the float32 sums before it run in another order), 2e-4
on the float outputs of one pass and 2e-3 on those downstream of a stored
bf16 intermediate in the whole stage.

The data path, the optimizers and the gradient cache on the card (plain
PyTorch there, around the kernels): the device store's gather equals the
host batch to the bit; the multi-tensor optimizers on CUDA tensors equal
the same steps on the CPU to rtol 1e-6 + atol 1e-7 (a scalar division may
round through x * (1/s) on one and x / s on the other); the cached gradient
equals `direct_value_and_grad` at 2N=240 in 4 chunks (TF32 off) to relative
L2 1e-4 per tensor, the loss to rtol 1e-5 (the chunks' gradients are added
in another order).
"""
import pytest
import torch

from spcl_torch.ops import convstage_cuda as cs
from spcl_torch.ops import supcon_cuda as sc

pytestmark = pytest.mark.gpu

D = 256


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the supcon kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc.build()
    cs.build()
    return torch.device("cuda")


def _inputs(n2, seed, pad_rows=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = n2 // 2
    labels = (torch.arange(n, device="cuda") % 3).int()
    z = torch.nn.functional.normalize(torch.randn(n2, D, generator=g, device="cuda"), dim=1)
    valid = torch.ones(n, device="cuda")
    if pad_rows:
        valid[-pad_rows:] = 0.0
    return z[:n].contiguous(), z[n:].contiguous(), labels, valid


def _operands(z1, z2, labels, valid):
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device=z.device)
    return z, t2, v2, gid


@pytest.mark.parametrize("n2,pad_rows", [(60, 0), (126, 5), (1024, 0)])
@pytest.mark.parametrize("mode,gamma", [("none", 1e9), ("soft", 8.0), ("hard", 30.0),
                                        ("hard", 0.5)])
def test_fwd_stats_and_dz_match_plain(cuda, n2, pad_rows, mode, gamma):
    z1, z2, labels, valid = _inputs(n2, seed=n2, pad_rows=pad_rows)
    z, t2, v2, gid = _operands(z1, z2, labels, valid)
    fargs = (z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, gamma, mode)
    before = dict(sc.LAUNCHES)
    k = sc.fwd_stats_kernel(*fargs)
    p = sc.fwd_stats_plain(*fargs)
    assert sc.LAUNCHES["supcon_fwd"] == before["supcon_fwd"] + 1
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=0)  # positive counts: exact
    torch.testing.assert_close(torch.log(k[0] + 1e-16), torch.log(p[0] + 1e-16),
                               rtol=0, atol=2e-4)
    c_safe = torch.clamp(p[1], min=1.0)
    torch.testing.assert_close(k[2] / c_safe, p[2] / c_safe, rtol=0, atol=2e-4)
    torch.testing.assert_close(k[3] / c_safe, p[3] / c_safe, rtol=0, atol=2e-4)

    c, denom, a = p[1], p[0], p[3] / c_safe
    scale = torch.full((1,), 1.0 / n2, device="cuda")
    bargs = (z, z, t2, t2, v2, v2, gid, gid, c, c, denom, denom, a, a, 1 / 0.07, gamma,
             scale, mode)
    dk = sc.bwd_dz_kernel(*bargs)
    dp = sc.bwd_dz_plain(*bargs)
    assert sc.LAUNCHES["supcon_bwd"] == before["supcon_bwd"] + 1
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))


@pytest.mark.parametrize("correct_grad", [False, True])
def test_autograd_on_card_matches_cpu(cuda, correct_grad):
    """The whole Function on the card (kernels) against the CPU (plain)."""
    z1, z2, labels, valid = _inputs(60, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        a = z1.detach().to(dev).clone().requires_grad_(True)
        b = z2.detach().to(dev).clone().requires_grad_(True)
        loss, ratio = sc.fused_self_paced_supcon(
            a, b, gamma=8.0, target=labels.to(dev), valid=valid.to(dev),
            weight_update="soft", correct_grad=correct_grad)
        loss.backward()
        out[dev] = (loss.detach().cpu(), ratio.cpu(), a.grad.cpu(), b.grad.cpu())
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("n2,world", [(128, 2), (64, 4), (1024, 8)])
@pytest.mark.parametrize("mode,gamma,correct_grad", [("none", 1e9, False), ("soft", 8.0, True),
                                                     ("hard", 30.0, False)])
def test_strip_kernels_match_plain_and_square_form(cuda, n2, world, mode, gamma, correct_grad):
    """rows != cols: every rank's strip of a virtual mesh (rows of that rank
    against the columns of all) against the plain versions, and the
    assembled loss, ratio and dz against the square-form kernels."""
    z1, z2, labels, valid = _inputs(n2, seed=n2 + world, pad_rows=3)
    before = dict(sc.LAUNCHES)
    w = sc.walk_strips(z1, z2, labels, valid, world, gamma=gamma, weight_update=mode,
                       correct_grad=correct_grad)
    assert sc.LAUNCHES["supcon_fwd"] == before["supcon_fwd"] + world
    assert sc.LAUNCHES["supcon_bwd"] == before["supcon_bwd"] + world
    scale = (1.0 / w["m"]).reshape(1)
    for rows, cols, stats_l, stats_g in w["strips"]:
        assert rows[0].shape[0] < cols[0].shape[0]
        ops = (rows[0], cols[0], rows[1], cols[1], rows[2], cols[2], rows[3], cols[3])
        k = sc.fwd_stats_kernel(*ops, 1 / 0.07, gamma, mode)
        p = sc.fwd_stats_plain(*ops, 1 / 0.07, gamma, mode)
        torch.testing.assert_close(k[1], p[1], rtol=0, atol=0)
        torch.testing.assert_close(torch.log(k[0] + 1e-16), torch.log(p[0] + 1e-16),
                                   rtol=0, atol=2e-4)
        c_safe = torch.clamp(p[1], min=1.0)
        torch.testing.assert_close(k[2] / c_safe, p[2] / c_safe, rtol=0, atol=2e-4)
        torch.testing.assert_close(k[3] / c_safe, p[3] / c_safe, rtol=0, atol=2e-4)
        stats = (stats_l[0], stats_g[0], stats_l[1], stats_g[1], stats_l[2], stats_g[2])
        dk = sc.bwd_dz_kernel(*ops, *stats, 1 / 0.07, gamma, scale, mode)
        dp = sc.bwd_dz_plain(*ops, *stats, 1 / 0.07, gamma, scale, mode)
        torch.testing.assert_close(dk, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))
    a, b = z1.clone().requires_grad_(True), z2.clone().requires_grad_(True)
    loss, ratio = sc.FusedSupCon.apply(a, b, labels, valid, gamma, 1 / 0.07, mode, correct_grad)
    loss.backward()
    torch.testing.assert_close(w["loss"], loss.detach(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(w["ratio"], ratio, rtol=0, atol=1e-5)
    tol = 2e-4 * float(torch.cat([a.grad, b.grad]).abs().max())
    torch.testing.assert_close(w["dz1"], a.grad, rtol=0, atol=tol)
    torch.testing.assert_close(w["dz2"], b.grad, rtol=0, atol=tol)


def test_sharded_fused_without_a_group_launches_the_kernels(cuda):
    z1, z2, labels, valid = _inputs(60, seed=2)
    a, b = z1.clone().requires_grad_(True), z2.clone().requires_grad_(True)
    before = dict(sc.LAUNCHES)
    loss, _ = sc.sharded_fused_self_paced_supcon(a, b, labels, valid, gamma=8.0)
    loss.backward()
    assert sc.LAUNCHES["supcon_fwd"] == before["supcon_fwd"] + 1
    assert sc.LAUNCHES["supcon_bwd"] == before["supcon_bwd"] + 1
    ref, _ = sc.fused_self_paced_supcon(z1, z2, gamma=8.0, target=labels, valid=valid,
                                        weight_update="soft")
    torch.testing.assert_close(loss.detach(), ref, rtol=2e-4, atol=2e-6)


def test_kernel_rejects_malformed_operands(cuda):
    z = torch.zeros(40, D, device="cuda")
    v = torch.ones(40, device="cuda")
    with pytest.raises(ValueError):  # rows not padded to the tile
        sc.fwd_stats_kernel(z, z, v, v, v, v, v, v, 1.0, 1.0, "hard")
    z = torch.zeros(64, D, device="cuda")
    v, short = torch.ones(64, device="cuda"), torch.ones(32, device="cuda")
    with pytest.raises(ValueError):  # a label vector shorter than the rows
        sc.fwd_stats_kernel(z, z, short, v, v, v, v, v, 1.0, 1.0, "hard")
    with pytest.raises(ValueError):  # float64 operands
        sc.fwd_stats_kernel(z.double(), z, v, v, v, v, v, v, 1.0, 1.0, "hard")


def _strip_operands(rows, cols, seed, invalid_tail=3):
    """Rows = the first `rows` entries of the columns (rank 0's strip of a
    row-sharded batch), labels in 3 partitions, an invalid tail of columns."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    zc = torch.nn.functional.normalize(torch.randn(cols, D, generator=g, device="cuda"), dim=1)
    lab = (torch.arange(cols, device="cuda") % 3).float()
    val = torch.ones(cols, device="cuda")
    val[cols - invalid_tail:] = 0.0
    gid = torch.arange(cols, dtype=torch.float32, device="cuda")
    return (zc[:rows].contiguous(), zc, lab[:rows].contiguous(), lab, val[:rows].contiguous(),
            val, gid[:rows].contiguous(), gid)


@pytest.mark.parametrize("rows,cols", [(32, 3840), (480, 3840), (96, 224)])
@pytest.mark.parametrize("mode,gamma", [("none", 1e9), ("soft", 8.0), ("hard", 30.0)])
def test_strip_shapes_match_plain(cuda, rows, cols, mode, gamma):
    """rows != cols at the strips of the bigbatch loss (480 x 3840), of one
    row tile against many columns (32 x 3840) and of 7 column tiles, which
    no cluster larger than 1 divides evenly (96 x 224)."""
    ops = _strip_operands(rows, cols, seed=rows + cols)
    k = sc.fwd_stats_kernel(*ops, 1 / 0.07, gamma, mode)
    p = sc.fwd_stats_plain(*ops, 1 / 0.07, gamma, mode)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=0)
    torch.testing.assert_close(torch.log(k[0] + 1e-16), torch.log(p[0] + 1e-16),
                               rtol=0, atol=2e-4)
    c_safe = torch.clamp(p[1], min=1.0)
    torch.testing.assert_close(k[2] / c_safe, p[2] / c_safe, rtol=0, atol=2e-4)
    torch.testing.assert_close(k[3] / c_safe, p[3] / c_safe, rtol=0, atol=2e-4)
    zc, lab, val, gid = ops[1], ops[3], ops[5], ops[7]
    den_c, c_c, _, sps_c = sc.fwd_stats_plain(zc, zc, lab, lab, val, val, gid, gid, 1 / 0.07,
                                              gamma, mode)
    a_c = sps_c / torch.clamp(c_c, min=1.0)
    stats = (c_c[:rows].contiguous(), c_c, den_c[:rows].contiguous(), den_c,
             a_c[:rows].contiguous(), a_c)
    scale = torch.full((1,), 1.0 / cols, device="cuda")
    dk = sc.bwd_dz_kernel(*ops, *stats, 1 / 0.07, gamma, scale, mode)
    dp = sc.bwd_dz_plain(*ops, *stats, 1 / 0.07, gamma, scale, mode)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))


def test_two_runs_bit_for_bit_at_3840(cuda):
    """No atomics: the sums across the blocks of a cluster run in a fixed
    order, so two runs of the same inputs give the same bits."""
    z1, z2, labels, valid = _inputs(3840, seed=5)
    z, t2, v2, gid = _operands(z1, z2, labels, valid)
    fargs = (z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, 8.0, "soft")
    first, second = sc.fwd_stats_kernel(*fargs), sc.fwd_stats_kernel(*fargs)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    c_safe = torch.clamp(first[1], min=1.0)
    bargs = (z, z, t2, t2, v2, v2, gid, gid, first[1], first[1], first[0], first[0],
             first[3] / c_safe, first[3] / c_safe, 1 / 0.07, 8.0,
             torch.full((1,), 1 / 3840, device="cuda"), "soft")
    assert torch.equal(sc.bwd_dz_kernel(*bargs), sc.bwd_dz_kernel(*bargs))


def test_one_launch_per_call_at_2n_60(cuda):
    """At the paper's 2N=60 each kernel is one launch per call, through the
    wrappers and through the loss's forward and backward."""
    z1, z2, labels, valid = _inputs(60, seed=6)
    z, t2, v2, gid = _operands(z1, z2, labels, valid)
    sc.reset_launch_counts()
    stats = sc.fwd_stats_kernel(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, 3.0, "hard")
    assert sc.LAUNCHES == {"supcon_fwd": 1, "supcon_bwd": 0}
    c_safe = torch.clamp(stats[1], min=1.0)
    sc.bwd_dz_kernel(z, z, t2, t2, v2, v2, gid, gid, stats[1], stats[1], stats[0], stats[0],
                     stats[3] / c_safe, stats[3] / c_safe, 1 / 0.07, 3.0,
                     torch.full((1,), 1 / 60, device="cuda"), "hard")
    assert sc.LAUNCHES == {"supcon_fwd": 1, "supcon_bwd": 1}
    a, b = z1.clone().requires_grad_(True), z2.clone().requires_grad_(True)
    sc.reset_launch_counts()
    loss, _ = sc.fused_self_paced_supcon(a, b, gamma=3.0, target=labels, valid=valid)
    loss.backward()
    assert sc.LAUNCHES == {"supcon_fwd": 1, "supcon_bwd": 1}
    assert sc.plan("supcon_fwd", 64, 64, D)["row_tiles"] == 1


@pytest.mark.parametrize("d,offset", [(102, 0), (256, 1)])
def test_ragged_depth_and_unaligned_rows_match_plain(cuda, d, offset):
    """A depth that is no multiple of 4, and z rows that start 4 bytes off a
    16-byte boundary: the wrappers hand the kernels padded, aligned copies."""
    g = torch.Generator(device="cuda").manual_seed(d + offset)
    unit = torch.nn.functional.normalize(torch.randn(96, d, generator=g, device="cuda"), dim=1)
    z = torch.empty(96 * d + offset, device="cuda")[offset:].view(96, d)
    z.copy_(unit)
    assert z.is_contiguous() and (z.data_ptr() % 16 != 0) == bool(offset)
    lab = (torch.arange(96, device="cuda") % 3).float()
    val, gid = torch.ones(96, device="cuda"), torch.arange(96, dtype=torch.float32, device="cuda")
    fargs = (z, z, lab, lab, val, val, gid, gid, 1 / 0.07, 8.0, "soft")
    k, p = sc.fwd_stats_kernel(*fargs), sc.fwd_stats_plain(*fargs)
    torch.testing.assert_close(torch.log(k[0] + 1e-16), torch.log(p[0] + 1e-16), rtol=0, atol=2e-4)
    torch.testing.assert_close(k[2] / torch.clamp(p[1], min=1.0), p[2] / torch.clamp(p[1], min=1.0),
                               rtol=0, atol=2e-4)
    a = p[3] / torch.clamp(p[1], min=1.0)
    bargs = (z, z, lab, lab, val, val, gid, gid, p[1], p[1], p[0], p[0], a, a, 1 / 0.07, 8.0,
             torch.full((1,), 1 / 96, device="cuda"), "soft")
    dk, dp = sc.bwd_dz_kernel(*bargs), sc.bwd_dz_plain(*bargs)
    assert dk.shape == (96, d)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))


def test_kernel_rejects_depth_beyond_its_limit(cuda):
    z = torch.zeros(32, sc.MAX_D + 8, device="cuda")
    v = torch.ones(32, device="cuda")
    with pytest.raises(ValueError):
        sc.fwd_stats_kernel(z, z, v, v, v, v, v, v, 1.0, 1.0, "hard")


# ------------------------------------------------------------------ stage kernels
def _stage_args(b, h, w, ci, c, external_first, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = rn(b, h, w, c if external_first else ci)
    w0 = None if external_first else rn(3, 3, ci, c, scale=(9 * ci) ** -0.5)
    args = (x, w0, 1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(3, 3, c, c, scale=(9 * c) ** -0.5),
            1 + rn(c, scale=0.1), rn(c, scale=0.1))
    return args, rn(b, h // 2, w // 2, c), rn(b, h, w, c)


# bfloat16 stage kernels: tolerances x max|plain|
BF16_STORED = 2.0 ** -7      # a bf16-stored tensor: one rounding apart
BF16_CHAINED = 2e-3          # float outputs downstream of a stored bf16 intermediate


def _assert_stage_close(got, want, chained=True):
    """Each tensor within 2e-4 x max|plain|; where the stage runs in bf16,
    bf16 outputs within BF16_STORED x max|plain| (the order of the float32
    sums before a rounding may differ) and float outputs within BF16_CHAINED
    where a stored bf16 intermediate lies between (`chained`, the whole
    stage), else 2e-4 (chip_smoke.py states these bounds)."""
    bf16 = any(p is not None and p.dtype == torch.bfloat16 for p in want)
    for k, p in zip(got, want):
        if p is None:
            assert k is None
            continue
        if bf16:
            assert k.dtype == p.dtype, (k.dtype, p.dtype)
        tol = (BF16_STORED if p.dtype == torch.bfloat16
               else BF16_CHAINED if bf16 and chained else 2e-4)
        scale = max(float(p.abs().max()), 1e-12)
        assert float((k.double() - p.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,ci,c,external_first", [
    (3, 20, 36, 16, 16, True), (3, 20, 36, 16, 32, False), (2, 32, 32, 16, 16, False),
    (2, 16, 48, 32, 32, False), (5, 64, 64, 16, 32, False),
    # ragged: H and W no multiples of the 16x16 tile, one image
    (1, 22, 38, 16, 32, False), (1, 18, 50, 32, 32, False), (1, 26, 14, 16, 16, True)])
def test_stage_kernels_match_plain(cuda, b, h, w, ci, c, external_first, dtype):
    """The stage forward and backward against the plain versions (for bf16
    inputs the bf16 instantiation against plain versions with the same
    rounding points), each pass alone on the same inputs, two runs bit for
    bit, launches counted under the dtype's own names."""
    args, dp, de = _stage_args(b, h, w, ci, c, external_first, seed=b + h)
    args = (args[0].to(dtype),) + args[1:]
    dp, de = dp.to(dtype), de.to(dtype)
    cs.reset_launch_counts()
    out_k, res = cs.stage_forward(*args, external_first)
    out_p, _ = cs.stage_forward(*args, external_first, plain=True)
    _assert_stage_close(out_k, out_p)
    for cot in ((dp, de), (dp, None), (None, de)):
        # both from the kernels' residuals: the same ReLU masks and pool maxima
        _assert_stage_close(cs.stage_backward(res, *cot, external_first),
                            cs.stage_backward(res, *cot, external_first, plain=True))
    own, other, suffix = ((cs.LAUNCHES_BF16, cs.LAUNCHES, "_bf16") if dtype == torch.bfloat16
                          else (cs.LAUNCHES, cs.LAUNCHES_BF16, ""))
    ran = [n for n in cs.PASSES if not (external_first and n in ("conv", "dwdx"))]
    assert sum(other.values()) == 0 and all(own[f"convstage_{n}{suffix}"] > 0 for n in ran)
    again, res2 = cs.stage_forward(*args, external_first)
    assert all(torch.equal(a, b2) for a, b2 in zip(out_k, again))  # fixed-order sums
    assert all(torch.equal(a, b2) for a, b2 in zip(cs.stage_backward(res, dp, de, external_first),
                                                   cs.stage_backward(res2, dp, de, external_first))
               if a is not None)
    x, z0, z1, w0, w1, g0, g1, mean0, var0, coef0, mean1, var1, coef1 = res
    n = b * h * w
    dcoef1 = cs.bn_bwd_coef(cs.poolsums_plain(z1, coef1, dp, de), n, mean1, var1, g1)[0]
    dz1 = cs.dz1_plain(z1, coef1, dcoef1, dp, de)
    dy0, _, sums_dy0 = cs.dwprev_plain(dz1, z0, coef0, w1)
    dcoef0 = cs.bn_bwd_coef(sums_dy0, n, mean0, var0, g0)[0]
    inputs = {"bnconv": (z0, coef0, w1), "bnpool": (z1, coef1),
              "poolsums": (z1, coef1, dp, de), "dz1": (z1, coef1, dcoef1, dp, de),
              "dwprev": (dz1, z0, coef0, w1)}
    if not external_first:
        inputs.update({"conv": (x, w0), "dwdx": (z0, dy0, dcoef0, x, w0)})
    for name, ins in inputs.items():
        got, want = cs._KERNEL_PASSES[name](*ins), cs._PLAIN_PASSES[name](*ins)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        _assert_stage_close(got, want, chained=False)


def _wide(g, *shape):
    """values of magnitude 1e-3..1e3 (log-uniform), random sign"""
    mag = 10.0 ** (torch.rand(*shape, generator=g, device="cuda") * 6 - 3)
    sign = torch.where(torch.rand(*shape, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    return mag * sign


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["conv", "bnconv", "dwprev", "dwdx"])
def test_stage_conv_kernels_hold_wide_range_against_float64(cuda, name, dtype):
    """Activations over six decades, where one TF32 pass misses the stage
    tolerance (tests/test_torch_convstage_tf32.py shows it on the CPU): the
    3xTF32 kernels hold 2e-4 x max|ref| against the pass in float64. The
    bf16 kernels, against the pass in float64 on the bf16 operands they
    multiply (`float64_pass`): 2e-4 x max|ref| on their float outputs
    (weight gradients, sums), BF16_STORED x max|ref| on those stored in bf16
    (one rounding, 2^-8 of an element at most). BN is the identity (inv 1,
    shift 0) and dz0 = dy0, so the ReLU masks of the kernels and the float64
    versions are the same."""
    g = torch.Generator(device="cuda").manual_seed(11)
    b, h, w, ci, c = 2, 40, 56, 16, 32
    coef = torch.stack([torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")])
    dcoef = torch.stack([torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"),
                         torch.zeros(c, device="cuda")])
    wt = torch.randn(3, 3, c if name in ("bnconv", "dwprev") else ci, c, generator=g,
                     device="cuda") / 12
    def wide(*shape):
        return _wide(g, *shape).to(dtype)

    inputs = {"conv": (wide(b, h, w, ci), wt),
              "bnconv": (wide(b, h, w, c), coef, wt),
              "dwprev": (wide(b, h, w, c), wide(b, h, w, c), coef, wt),
              "dwdx": (wide(b, h, w, c), wide(b, h, w, c), dcoef, wide(b, h, w, ci), wt)}[name]
    got = cs._KERNEL_PASSES[name](*inputs)
    for k, ref in zip(got, cs.float64_pass(name, *inputs)):
        tol = BF16_STORED if k.dtype == torch.bfloat16 else 2e-4
        assert float((k.double() - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32])
def test_bnconv_and_dwprev_two_runs_bit_for_bit(cuda, c, dtype):
    """The four convolution passes, twice on the same inputs (conv and dwdx
    16 -> c): the same bits."""
    args, dp, de = _stage_args(3, 40, 40, 16, c, False, seed=c)
    x, w0, w1 = args[0].to(dtype), args[1], args[4]
    z0, dz1, dy0 = de.to(dtype), dp.repeat(1, 2, 2, 1).to(dtype).contiguous(), de.to(dtype)
    coef = torch.stack([1 + 0.1 * de[0, 0, 0].float(), 0.1 * de[0, 0, 1].float()]).contiguous()
    dcoef = torch.stack([1 + 0.1 * de[0, 1, 0].float(), 0.1 * de[0, 1, 1].float(),
                         0.01 * de[0, 1, 2].float()]).contiguous()
    for fn, inputs in ((cs.bnconv_kernel, (z0, coef, w1)),
                       (cs.dwprev_kernel, (dz1, z0, coef, w1)),
                       (cs.conv_kernel, (x, w0)),
                       (cs.dwdx_kernel, (z0, dy0, dcoef, x, w0))):
        first, second = fn(*inputs), fn(*inputs)
        assert all(torch.equal(a, a2) for a, a2 in zip(first, second))


@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (3, 20, 36), (5, 26, 14), (60, 34, 50)])
@pytest.mark.parametrize("ci,co", [(16, 16), (16, 32), (32, 32)])
def test_bf16_conv_and_dwdx_match_plain(cuda, b, h, w, ci, co):
    """conv and dwdx in bf16 (conv_fwd_bf16_kernel, conv_bwd_bf16_kernel)
    against their plain bf16 versions at every (ci, co) the entry points
    take, at H and W no multiples of the 16x16 tile and B = 1 to 60: bf16
    outputs (z0, dx) within BF16_STORED x max|plain|, float ones (the sums,
    dW0) within 2e-4; one launch each, counted under the bf16 names."""
    g = torch.Generator(device="cuda").manual_seed(b * h + ci + co)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x, z0, dy0 = rn(b, h, w, ci), rn(b, h, w, co), rn(b, h, w, co, scale=0.1)
    x, z0, dy0 = x.to(torch.bfloat16), z0.to(torch.bfloat16), dy0.to(torch.bfloat16)
    w0 = rn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
    dcoef = torch.stack([1 + rn(co, scale=0.1), rn(co, scale=0.01), rn(co, scale=0.01)])
    cs.reset_launch_counts()
    for name, inputs in (("conv", (x, w0)), ("dwdx", (z0, dy0, dcoef, x, w0))):
        got, want = cs._KERNEL_PASSES[name](*inputs), cs._PLAIN_PASSES[name](*inputs)
        assert got[0].dtype == torch.bfloat16
        _assert_stage_close(got, want, chained=False)
    assert cs.LAUNCHES_BF16["convstage_conv_bf16"] == cs.LAUNCHES_BF16["convstage_dwdx_bf16"] == 1
    assert sum(cs.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("co", [16, 32])
def test_bn_backward_in_the_plain_order_bit_for_bit(cuda, co, dtype):
    """dz1 and dwdx's dz0 = (c0*dy + c1) + c2*z, on inputs where the fused
    order c0*dy + (c2*z + c1) gives other float32 values everywhere and
    other bf16 values at about half the elements (`bn_bwd_ties`,
    tests/torch_bf16_edges.py): dz1_kernel equals dz1_plain bit for bit,
    and dwdx's dz0 equals the plain version's, read through dW0: at B = 1, x
    one-hot at pixel p_i in channel i makes dW0[u, v, i] = dz0[p_i - (u-1,
    v-1)], one exact product beside zeros, in the kernel and in the plain
    version (on the CPU) alike."""
    from torch_bf16_edges import bn_bwd_ties

    b, h, w, ci = 1, 20, 36, 16
    dy, z, dcoef = (torch.from_numpy(a) for a in bn_bwd_ties(b, h, w, co, seed=co))
    dy, z = dy.to(dtype), z.to(dtype)
    coef = torch.stack([torch.ones(co), torch.zeros(co)])  # y1 = z1 >= 0: dy1 = de
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    got = cs.dz1_kernel(*(t.cuda() for t in (z, coef, dcoef)), None, dy.cuda()).cpu()
    want = cs.dz1_plain(z, coef, dcoef, None, dy)
    assert torch.equal(got.view(bits), want.view(bits))
    x = torch.zeros(b, h, w, ci, dtype=dtype)
    for i in range(ci):  # interior pixels, across the 16 x 16 tiles' edges
        x[0, 2 + (7 * i) % (h - 4), 2 + (11 * i) % (w - 4), i] = 1
    w0 = torch.randn(3, 3, ci, co, generator=torch.Generator().manual_seed(co)) / 12
    inputs = (z, dy, dcoef, x, w0)
    _, dw_got = cs.dwdx_kernel(*(t.cuda() for t in inputs))
    _, dw_want = cs.dwdx_plain(*inputs)
    assert bool((dw_want != 0).all())
    assert torch.equal(dw_got.cpu(), dw_want)


def test_stage_autograd_on_card_matches_cpu(cuda):
    args, dp, de = _stage_args(2, 16, 32, 16, 32, False, seed=7)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in args]
        cs.reset_launch_counts()
        p, e = cs.fused_conv_stage(*leaves)[:2]
        ((p * dp.to(dev)).sum() + (e * de.to(dev)).sum()).backward()
        launched = sum(cs.LAUNCHES.values())
        assert launched == (7 if dev == "cuda" else 0)
        grads[dev] = [t.grad.cpu() for t in leaves]
    for k, p_ in zip(grads["cuda"], grads["cpu"]):
        assert float((k - p_).abs().max()) <= 5e-4 * float(p_.abs().max())


def test_stage_kernels_reject_malformed_operands(cuda):
    z = torch.zeros(2, 8, 8, 16, device="cuda")
    coef = torch.zeros(2, 16, device="cuda")
    with pytest.raises(ValueError):  # channels the kernels are not built for
        cs.bnpool_kernel(torch.zeros(2, 8, 8, 8, device="cuda"), coef[:, :8].contiguous())
    with pytest.raises(ValueError):  # odd height in a pool pass
        cs.bnpool_kernel(torch.zeros(2, 7, 8, 16, device="cuda"), coef)
    with pytest.raises(ValueError):  # not contiguous
        cs.bnpool_kernel(z.permute(0, 2, 1, 3), coef)
    with pytest.raises(ValueError):  # float64
        cs.bnconv_kernel(z.double(), coef, torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(ValueError):  # weights of another shape
        cs.bnconv_kernel(z, coef, torch.zeros(3, 3, 16, 32, device="cuda"))
    with pytest.raises(ValueError):  # dp of the wrong size
        cs.poolsums_kernel(z, coef, torch.zeros(2, 8, 8, 16, device="cuda"), None)


# ------------------------------------------------------------------ poolsums in one launch
def _pool_inputs(b, h, w, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    coef = torch.stack([1 + 0.1 * rn(c), 0.1 * rn(c)]).contiguous()
    return rn(b, h, w, c), coef, rn(b, h // 2, w // 2, c), rn(b, h, w, c)


POOL_SHAPES = [(60, 224, 224, 16), (60, 112, 112, 32), (5, 224, 224, 16), (5, 112, 112, 32),
               (3, 20, 36, 16), (3, 20, 36, 32)]


@pytest.mark.parametrize("cotangents", ["dp and de", "de absent", "dp absent"])
@pytest.mark.parametrize("b,h,w,c", POOL_SHAPES)
def test_poolsums_kernel_matches_plain(cuda, b, h, w, c, cotangents):
    """The main path's stage shapes (B=60 pretrain, B=5 fine-tune) and a small
    odd batch whose rows are no multiple of a warp, within the stage
    tolerance; one launch a call; two runs give the same bits."""
    z1, coef, dp, de = _pool_inputs(b, h, w, c, seed=b + h + c)
    dp = None if cotangents == "dp absent" else dp
    de = None if cotangents == "de absent" else de
    before = cs.LAUNCHES["convstage_poolsums"]
    got = cs.poolsums_kernel(z1, coef, dp, de)
    assert cs.LAUNCHES["convstage_poolsums"] == before + 1
    _assert_stage_close((got,), (cs.poolsums_plain(z1, coef, dp, de),))
    assert torch.equal(got, cs.poolsums_kernel(z1, coef, dp, de))


def test_poolsums_back_to_back_calls_equal_the_first(cuda):
    """The arrival counter is zero again after every launch: 100 calls in a
    row on one stream give the first call's bits."""
    z1, coef, dp, de = _pool_inputs(60, 112, 112, 32, seed=3)
    first = cs.poolsums_kernel(z1, coef, dp, de)
    outs = [cs.poolsums_kernel(z1, coef, dp, de) for _ in range(100)]
    assert all(torch.equal(first, o) for o in outs)
    assert int(cs._ticket(z1.device).item()) == 0


def test_poolsums_graph_replays_equal_the_eager_call(cuda):
    z1, coef, dp, de = _pool_inputs(5, 224, 224, 16, seed=4)
    eager = cs.poolsums_kernel(z1, coef, dp, None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cs.poolsums_kernel(z1, coef, dp, None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cs.poolsums_kernel(z1, coef, dp, None)
    for _ in range(10):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert torch.equal(cs.poolsums_kernel(z1, coef, dp, None), eager)


def test_poolsums_is_one_kernel_launch(cuda):
    """No second pass: the profiler sees one kernel for one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    z1, coef, dp, de = _pool_inputs(3, 20, 36, 32, seed=5)
    cs.poolsums_kernel(z1, coef, dp, de)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.poolsums_kernel(z1, coef, dp, de)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "poolsums_kernel" in names[0], names


def test_poolsums_rejects_malformed_operands(cuda):
    z1, coef, dp, de = _pool_inputs(2, 8, 8, 16, seed=6)
    with pytest.raises(ValueError):  # odd width
        cs.poolsums_kernel(torch.zeros(2, 8, 7, 16, device="cuda"), coef, None, None)
    with pytest.raises(ValueError):  # channels the kernel is not built for
        cs.poolsums_kernel(torch.zeros(2, 8, 8, 8, device="cuda"), coef[:, :8].contiguous(),
                           None, None)
    with pytest.raises(ValueError):  # de of another shape
        cs.poolsums_kernel(z1, coef, dp, de[:, :6].contiguous())
    with pytest.raises(ValueError):  # dp of another shape
        cs.poolsums_kernel(z1, coef, dp[:, :3].contiguous(), de)
    with pytest.raises(ValueError):  # not contiguous
        cs.poolsums_kernel(z1.permute(0, 2, 1, 3), coef, dp, de)
    with pytest.raises(ValueError):  # float64
        cs.poolsums_kernel(z1.double(), coef, dp, de)
    with pytest.raises(ValueError):  # coefficients of another size
        cs.poolsums_kernel(z1, coef[:, :8].contiguous(), dp, de)
    with pytest.raises(ValueError):  # on the CPU
        cs.poolsums_kernel(z1.cpu(), coef, dp, de)


# ------------------------------------------------------------------ data, optimizers, grad_cache
def test_store_gather_on_card_equals_host_batch(cuda):
    import numpy as np
    from spcl_torch.data import DeviceStore, synthetic_dataset
    root = synthetic_dataset("acdc", num_scans=4, slices_per_scan=(6, 8), canvas=64, seed=2)
    idx = np.array([5, -1, 0, 11, 11, -1, 2], np.int64)
    got = DeviceStore(root, "cuda").gather(torch.from_numpy(idx).cuda())
    want = root.batch(idx)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].is_cuda and torch.equal(got[k].cpu(), torch.from_numpy(v)), k


@pytest.mark.parametrize("chain", [dict(name="RAdam", weight_decay=1e-5),
                                   dict(name="adam", weight_decay=1e-2),
                                   dict(name="adamw", weight_decay=1e-2),
                                   dict(name="sgd", momentum=0.9, nesterov=True),
                                   dict(name="adam", grad_clip=0.02)],
                         ids=lambda c: c["name"] + ("-clip" if "grad_clip" in c else ""))
def test_foreach_optimizers_on_card_match_cpu(cuda, chain):
    from spcl_torch.training import build_optimizer
    g = torch.Generator().manual_seed(3)
    shapes = [(16, 1, 3, 3), (16,), (256, 256), (7,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 1e-2 for s in shapes] for _ in range(10)]
    out = {}
    for dev in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = build_optimizer(ps, lr=1e-3, **chain)
        for step in grads:
            for p, gr in zip(ps, step):
                p.grad = gr.to(dev)
            opt.step()
        out[dev] = [p.detach().cpu() for p in ps]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_gradcache_cached_equals_direct_on_card(cuda):
    from spcl_torch.data import DeviceStore, synthetic_dataset
    from spcl_torch.data.augment import AugmentPolicy
    from spcl_torch.hooks import SelfPacedINFONCEHook
    from spcl_torch.models import UNet, set_trainable_stages, stages_from_range
    from spcl_torch.training import build_gradcache_pretrain_step, build_optimizer
    from spcl_torch.training.steps import draw_pretrain_params
    torch.manual_seed(0)
    root = synthetic_dataset("acdc", num_scans=12, slices_per_scan=(10, 12), canvas=48, seed=0)
    store = DeviceStore(root, "cuda")
    net = UNet(max_channel=128).cuda()
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", mode="soft", begin_value=50.0,
                                end_value=5.0, max_epoch=2)
    hook.build(net, "cuda")
    opt = build_optimizer([p for p in net.parameters() if p.requires_grad] + hook.parameters(),
                          name="RAdam", lr=1e-4)
    policy = AugmentPolicy(crop=32, rot_degrees=10.0)
    step = build_gradcache_pretrain_step(net, [hook], opt, policy=policy, total_freedom=True,
                                         until="Conv5", num_chunks=4, store=store)
    idx = torch.arange(120, device="cuda")
    draws = draw_pretrain_params(torch.Generator(device="cuda").manual_seed(1), idx, store,
                                 policy=policy, total_freedom=True)
    scalars = {"sp": hook.epoch_scalars(0)}
    direct = step.direct_value_and_grad(idx, None, scalars, params=draws)
    cached = step.cached_value_and_grad(idx, None, scalars, params=draws)
    torch.testing.assert_close(cached["loss"], direct["loss"], rtol=1e-5, atol=0)
    assert len(cached["grads"]) == len(direct["grads"]) > 30
    for c, d in zip(cached["grads"], direct["grads"]):
        assert float((c - d).norm() / d.norm()) <= 1e-4


# ------------------------------------------------------------------ the semi path (slice E)
# the stage kernels at the semi step's shapes: the student at 32 labeled + 2 x
# 32 unlabeled slices, the EMA teacher at 32 (forward only on the path; the
# backward is held too)
@pytest.mark.parametrize("b,h,w,ci,c,external_first", [
    (96, 224, 224, 16, 16, True), (96, 112, 112, 16, 32, False),
    (32, 224, 224, 16, 16, True), (32, 112, 112, 16, 32, False)])
def test_stage_kernels_at_the_semi_shapes_match_plain(cuda, b, h, w, ci, c, external_first):
    args, dp, de = _stage_args(b, h, w, ci, c, external_first, seed=b + c)
    out_k, res = cs.stage_forward(*args, external_first)
    out_p, _ = cs.stage_forward(*args, external_first, plain=True)
    _assert_stage_close(out_k, out_p)
    del out_p
    _assert_stage_close(cs.stage_backward(res, dp, de, external_first),
                        cs.stage_backward(res, dp, de, external_first, plain=True))


@pytest.mark.parametrize("pad_rows", [0, 1])
def test_supcon_kernels_at_the_infonce_presets_size(cuda, pad_rows):
    """2N = 10 (5 unlabeled slices, two views), weighting `none`, as the
    `infonce` / `infoncemt` presets run the kernels; with a padded row too."""
    test_fwd_stats_and_dz_match_plain(cuda, 10, pad_rows, "none", 1e9)


def _semi_run(dev, base, draws, batches):
    import copy
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL
    from spcl_torch.hooks import creator
    from spcl_torch.models import EMATeacher
    from spcl_torch.training import build_optimizer, build_semi_step
    model = copy.deepcopy(base).to(dev)
    teacher = EMATeacher(model)
    opt = build_optimizer(list(model.parameters()), lr=1e-4, weight_decay=1e-5)
    step = build_semi_step(model, [creator.create_consistency_hook(5.0),
                                   creator.create_mt_hook(10.0)], opt, num_classes=4,
                           policy=dataclasses.replace(ACDC_LABEL, crop=32), teacher=teacher)
    on_dev = [{k: v.to(dev) for k, v in b.items()} for b in batches]

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(to(v) for v in tree)
        return tree.to(dev)

    cs.reset_launch_counts()
    m = step(*on_dev, None, {}, params=to(draws))
    return m, dict(cs.LAUNCHES), model, teacher


# |card - cpu| / |cpu| (L2) of each parameter's gradient: chip_smoke.py's
# SEMI_GRAD_TOL (max-pool and ReLU routing sets the floor; see there)
SEMI_GRAD_TOL = 5e-2


def test_semi_step_on_card_matches_cpu(cuda):
    """One semi step (mean teacher + consistency) of a UNet-256 under
    `pallas` at crop 32: the card (stage kernels) against the CPU (plain
    versions), from the same weights and draws. Losses rtol 1e-4, student
    and teacher parameters and running statistics atol 1e-5, each
    parameter's gradient to SEMI_GRAD_TOL of its L2 norm (TF32 off)."""
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL
    from spcl_torch.models import UNet
    from spcl_torch.training import draw_semi_params
    g = torch.Generator().manual_seed(3)
    n = 4
    lab = {"image": torch.randint(0, 255, (n, 1, 48, 48), generator=g, dtype=torch.uint8),
           "label": torch.randint(0, 4, (n, 48, 48), generator=g, dtype=torch.uint8),
           "valid": torch.ones(n)}
    unl = {"image": torch.randint(0, 255, (n, 1, 48, 48), generator=g, dtype=torch.uint8),
           "label": torch.zeros(n, 48, 48, dtype=torch.uint8),
           "partition": torch.arange(n, dtype=torch.int32) % 3,
           "patient": torch.zeros(n, dtype=torch.int32), "cycle": torch.zeros(n, dtype=torch.int32),
           "scan_idx": torch.zeros(n, dtype=torch.int32), "valid": torch.tensor([1., 1, 1, 0])}
    draws = draw_semi_params(g, lab, unl, None, policy=dataclasses.replace(ACDC_LABEL, crop=32))
    torch.manual_seed(4)
    base = UNet(max_channel=256, small_c_layout="pallas")
    runs = {dev: _semi_run(dev, base, draws, (lab, unl)) for dev in ("cuda", "cpu")}
    (mk, lk, sk, tk), (mp, lp, sp, tp) = runs["cuda"], runs["cpu"]
    assert lk == {"convstage_conv": 2, "convstage_bnconv": 4, "convstage_bnpool": 4,
                  "convstage_poolsums": 2, "convstage_dz1": 2, "convstage_dwprev": 2,
                  "convstage_dwdx": 1}
    assert sum(lp.values()) == 0
    for k in ("sup_loss", "reg_loss"):
        torch.testing.assert_close(mk[k].cpu(), mp[k], rtol=1e-4, atol=0)
    for a, b in ((sk.state_dict(), sp.state_dict()), (tk.model.state_dict(),
                                                        tp.model.state_dict())):
        for key in a:
            torch.testing.assert_close(a[key].cpu().double(), b[key].double(), rtol=0,
                                       atol=1e-5, msg=key)
    # the step's gradients, left in .grad: one RAdam step moves a parameter
    # by lr x g only, so the parameters alone hold g loosely
    gp = dict(sp.named_parameters())
    for name, p in sk.named_parameters():
        ref = gp[name].grad.double()
        err = float((p.grad.cpu().double() - ref).norm() / ref.norm())
        assert err <= SEMI_GRAD_TOL, (name, err)


def test_teacher_forward_under_pallas_leaves_running_statistics(cuda):
    """The EMA teacher's forward at the semi path's shape (32 slices, 224^2)
    launches the fused stages' forward passes and moves no running
    statistic; the student's own train-mode forward moves them."""
    from spcl_torch.models import EMATeacher, UNet
    student = UNet(max_channel=256, small_c_layout="pallas").cuda()
    teacher = EMATeacher(student)
    before = {k: v.clone() for k, v in teacher.model.state_dict().items()}
    cs.reset_launch_counts()
    x = torch.rand(32, 1, 224, 224, device="cuda")
    logits = teacher.logits(x)
    assert logits.shape == (32, 4, 224, 224) and bool(torch.isfinite(logits).all())
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "convstage_conv": 1, "convstage_bnconv": 2, "convstage_bnpool": 2}
    for k, v in teacher.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        student.train()
        student(x)
    assert int(student._Conv1.conv[1].num_batches_tracked) == 1


# ------------------------------------------------------------------ decoder pretraining and the adversarial step (slices F, G)
@pytest.mark.parametrize("pad_rows", [0, 5])
@pytest.mark.parametrize("mode,gamma,correct_grad", [("none", 1e9, False), ("soft", 8.0, True),
                                                     ("hard", 5.0, False)])
def test_supcon_kernels_at_the_dense_infonce_size(cuda, pad_rows, mode, gamma, correct_grad):
    """2N = 90 (9 slices x 5 points, two views) with the dense hook's
    SimCLR-pair targets (each row's only positive its other view, -1 on
    padding): the autograd Function's loss, ratio and dz on the kernels
    against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(90 + pad_rows)
    n = 45
    base = torch.randn(n, D, generator=g, device="cuda")
    z = torch.nn.functional.normalize(
        torch.cat([base, base]) + 0.7 * torch.randn(2 * n, D, generator=g, device="cuda"), dim=1)
    valid = torch.ones(n, device="cuda")
    if pad_rows:
        valid[-pad_rows:] = 0.0
    labels = torch.where(valid > 0, torch.arange(n, device="cuda"), -1).int()
    out = {}
    for use_kernel in (True, False):
        saved = (sc.fwd_stats_kernel, sc.bwd_dz_kernel)
        if not use_kernel:
            sc.fwd_stats_kernel, sc.bwd_dz_kernel = sc.fwd_stats_plain, sc.bwd_dz_plain
        try:
            before = dict(sc.LAUNCHES)
            a, b = z[:n].clone().requires_grad_(True), z[n:].clone().requires_grad_(True)
            loss, ratio = sc.FusedSupCon.apply(a, b, labels, valid, gamma, 1 / 0.07, mode,
                                               correct_grad)
            loss.backward()
            launched = {k: sc.LAUNCHES[k] - before[k] for k in before}
        finally:
            sc.fwd_stats_kernel, sc.bwd_dz_kernel = saved
        assert launched == ({"supcon_fwd": 1, "supcon_bwd": 1} if use_kernel
                            else {"supcon_fwd": 0, "supcon_bwd": 0})
        out[use_kernel] = (loss.detach(), ratio, torch.cat([a.grad, b.grad]))
    (lk, rk, dk), (lp, rp, dp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, rtol=0, atol=2e-4 * max(1.0, float(lp.abs())))
    torch.testing.assert_close(rk, rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))
    if pad_rows:  # the padded slices take no gradient
        assert not dk[n - pad_rows:n].any()


def _on(tree, dev):
    """A tree of dicts, tuples and tensors with every tensor moved to dev."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on(v, dev) for v in tree)
    return tree.to(dev)


def _small_batch(g, n, labeled):
    out = {"image": torch.randint(0, 255, (n, 1, 48, 48), generator=g, dtype=torch.uint8),
           "label": (torch.randint(0, 4, (n, 48, 48), generator=g, dtype=torch.uint8)
                     if labeled else torch.zeros(n, 48, 48, dtype=torch.uint8)),
           "partition": torch.arange(n, dtype=torch.int32) % 3,
           "patient": torch.zeros(n, dtype=torch.int32),
           "cycle": torch.zeros(n, dtype=torch.int32),
           "scan_idx": torch.zeros(n, dtype=torch.int32), "valid": torch.ones(n)}
    out["valid"][-1] = 0.0
    return out


def test_decoder_pretrain_step_on_card_matches_cpu(cuda):
    """One decoder-pretrain step (Up_conv3, `self`, Conv5..Up_conv3
    trainable) of a UNet-256 under `pallas` at crop 32, 6 slices: the fused
    stages run forward only (no backward pass launches), one supcon_fwd and
    one supcon_bwd; the card against the CPU from the same weights and
    draws: loss rtol 1e-4, parameters atol 1e-5 after one RAdam step, the
    frozen stages bit-equal."""
    import copy
    import dataclasses
    from spcl_torch.data.augment import ACDC_PRETRAIN
    from spcl_torch.hooks import INFONCEHook
    from spcl_torch.models import UNet, set_trainable_stages, stages_from_range
    from spcl_torch.training import build_optimizer, build_pretrain_step
    from spcl_torch.training.steps import draw_pretrain_params
    policy = dataclasses.replace(ACDC_PRETRAIN, crop=32)
    g = torch.Generator().manual_seed(5)
    batch = _small_batch(g, 6, labeled=False)
    draws = draw_pretrain_params(g, batch, None, policy=policy, total_freedom=False)
    hook_draws = {"ys": torch.randint(0, 10, (6, 5), generator=g),
                  "xs": torch.randint(0, 10, (6, 5), generator=g)}
    torch.manual_seed(6)
    base = UNet(max_channel=256, small_c_layout="pallas")
    set_trainable_stages(base, stages_from_range("Conv5", "Up_conv3"))
    head = INFONCEHook(name="d", feature_name="Up_conv3", contrast_on="self").build(base, "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        hook = INFONCEHook(name="d", feature_name="Up_conv3", contrast_on="self")
        hook.projector = copy.deepcopy(head).to(dev)
        params = [p for p in model.parameters() if p.requires_grad] + hook.parameters()
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_pretrain_step(model, [hook], opt, policy=policy, total_freedom=False,
                                   until="Up_conv3")
        cs.reset_launch_counts()
        sc.reset_launch_counts()
        m = step(_on(batch, dev), None, {},
                 params=_on({**draws, "hooks": {"d": hook_draws}}, dev))
        runs[dev] = (float(m["reg_loss"]), {**cs.LAUNCHES, **sc.LAUNCHES},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (lk, nk, sk), (lp, np_, sp) = runs["cuda"], runs["cpu"]
    assert {k: v for k, v in nk.items() if v} == {
        "convstage_conv": 1, "convstage_bnconv": 2, "convstage_bnpool": 2,
        "supcon_fwd": 1, "supcon_bwd": 1}
    assert not any(np_.values())
    assert abs(lk - lp) <= 1e-4 * max(1.0, abs(lp))
    before = base.state_dict()
    for k, v in sk.items():
        if "running" in k or "num_batches" in k:
            continue
        torch.testing.assert_close(v, sp[k], rtol=0, atol=1e-5, msg=k)
        if k.split(".")[0][1:] not in ("Conv5", "Up5", "Up_conv5", "Up4", "Up_conv4", "Up3",
                                       "Up_conv3"):
            assert torch.equal(v, before[k]), k


def test_adversarial_step_on_card_matches_cpu(cuda):
    """One adversarial step (reg_weight 0.5, dis_consider_image) of a
    UNet-256 under `pallas` at crop 32, 4 + 4 slices: the stage kernels
    twice (labeled and unlabeled forward and backward), the card against
    the CPU from the same weights, discriminator and draws: losses rtol
    1e-4, the student atol 1e-5, running statistics atol 1e-5, every
    gradient (student and discriminator) to SEMI_GRAD_TOL; the
    discriminator's update (Adam's first step follows sign(g); see
    tests/test_torch_adversarial.py) equal to Adam's step replayed on the
    CPU from the card's own gradients (atol 1e-7), and to the CPU's update
    within SEMI_GRAD_TOL relative L2."""
    import copy
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL
    from spcl_torch.models import Discriminator, UNet
    from spcl_torch.training import (Adam, build_adversarial_step, build_optimizer,
                                     draw_adversarial_params)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    g = torch.Generator().manual_seed(7)
    lab, unl = _small_batch(g, 4, labeled=True), _small_batch(g, 4, labeled=False)
    lab["valid"][:] = 1.0
    draws = draw_adversarial_params(g, lab, unl, None, policy=policy)
    torch.manual_seed(8)
    base, base_d = UNet(max_channel=256, small_c_layout="pallas"), Discriminator(5)
    runs = {}
    for dev in ("cuda", "cpu"):
        model, d = copy.deepcopy(base).to(dev), copy.deepcopy(base_d).to(dev)
        opt = build_optimizer(list(model.parameters()), lr=1e-4, weight_decay=1e-5)
        dopt = Adam(d.parameters(), lr=1e-4, betas=(0.5, 0.999))
        step = build_adversarial_step(model, d, opt, dopt, num_classes=4, policy=policy,
                                      reg_weight=0.5, dis_consider_image=True)
        cs.reset_launch_counts()
        m = step(_on(lab, dev), _on(unl, dev), None, params=_on(draws, dev))
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
        grads.update({f"d.{n}": p.grad.detach().cpu().double() for n, p in d.named_parameters()})
        runs[dev] = ({k: float(m[k]) for k in ("sup_loss", "gen_loss", "dis_loss")},
                     dict(cs.LAUNCHES), {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     {k: v.detach().cpu() for k, v in d.state_dict().items()}, grads)
    (lk, nk, sk, dk, gk), (lp, np_, sp, dp, gp) = runs["cuda"], runs["cpu"]
    assert nk == {"convstage_conv": 2, "convstage_bnconv": 4, "convstage_bnpool": 4,
                  "convstage_poolsums": 4, "convstage_dz1": 4, "convstage_dwprev": 4,
                  "convstage_dwdx": 2}
    assert not any(np_.values())
    for k in lk:
        assert abs(lk[k] - lp[k]) <= 1e-4 * max(1.0, abs(lp[k])), k
    for k, v in sk.items():
        torch.testing.assert_close(v.double(), sp[k].double(), rtol=0, atol=1e-5, msg=k)
    for name, ref in gp.items():
        assert float((gk[name] - ref).norm() / ref.norm()) <= SEMI_GRAD_TOL, name
    d0 = base_d.state_dict()
    replay = copy.deepcopy(base_d)
    for name, p in replay.named_parameters():
        p.grad = gk[f"d.{name}"].float()
    Adam(replay.parameters(), lr=1e-4, betas=(0.5, 0.999)).step()
    for k, v in replay.state_dict().items():
        torch.testing.assert_close(dk[k], v, rtol=0, atol=1e-7, msg=k)
    for k, v in dp.items():
        assert float((dk[k] - v).norm() / (v - d0[k]).norm()) <= SEMI_GRAD_TOL, k


# ------------------------------------------------------------------ bfloat16 stage kernels
def test_bf16_stage_kernels_reject_mixed_dtypes(cuda):
    z = torch.zeros(2, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
    coef = torch.zeros(2, 16, device="cuda")
    with pytest.raises(ValueError):  # dp in float32 beside bf16 z1
        cs.poolsums_kernel(z, coef, torch.zeros(2, 4, 4, 16, device="cuda"), None)
    with pytest.raises(ValueError):  # float16 is not built
        cs.bnpool_kernel(z.half(), coef)
    with pytest.raises(ValueError):  # bf16 weights: the kernels take float32 weights
        cs.bnconv_kernel(z, coef, torch.zeros(3, 3, 16, 16, device="cuda",
                                              dtype=torch.bfloat16))


@pytest.mark.parametrize("b,h,w,c", [(3, 20, 36, 16), (2, 34, 50, 32), (60, 112, 112, 32)])
def test_bf16_dwprev_and_bnconv_at_the_mask_edges(cuda, b, h, w, c):
    """bf16 dwprev and bnconv on inputs whose y0 = z0*inv + shift is +0,
    -0.0, a tiny negative (a subnormal bf16 keeps, one that rounds to -0.0 in
    bf16, a normal) or halfway between two bf16 values (tests/
    torch_bf16_edges.py): dy0 equals `dwprev_plain`'s bit for bit where the
    plain version masks it (y0 < 0 unrounded) and holds the stage tolerances
    elsewhere, as do dW1, the sums and bnconv's z1 and sums."""
    from torch_bf16_edges import pass_inputs

    z0, coef, dz1, w1 = (torch.from_numpy(a).cuda() for a in pass_inputs(b, h, w, c, seed=c))
    z0, dz1 = z0.to(torch.bfloat16), dz1.to(torch.bfloat16)
    y0 = z0.float() * coef[0] + coef[1]
    masked = ~(y0 >= 0)
    assert bool(masked.any()) and bool((y0 == 0).any())
    got, want = cs.dwprev_kernel(dz1, z0, coef, w1), cs.dwprev_plain(dz1, z0, coef, w1)
    assert torch.equal(got[0][masked].view(torch.int16), want[0][masked].view(torch.int16))
    _assert_stage_close(got, want, chained=False)
    _assert_stage_close(cs.bnconv_kernel(z0, coef, w1), cs.bnconv_plain(z0, coef, w1),
                        chained=False)


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_artifact_on_the_card_matches_the_live_module(cuda, tmp_path, dtype):
    """An artifact exported on the CPU (weights stored there) and loaded with
    device="cuda" runs on the card and gives the live eval-mode module's
    logits there: within 1e-4 in float32 (TF32 off), 2^-7 x max|logits| in
    bf16; the same pred wherever the top two logits are further apart."""
    from spcl_torch.models import UNet
    from spcl_torch.serving import export_inference, load_artifact, save_artifact

    torch.manual_seed(0)
    net = UNet(input_dim=1, num_classes=4, max_channel=128, dtype=dtype).eval()
    path = str(tmp_path / "m.spclt")
    save_artifact(path, export_inference(net, height=64, width=64))
    served = load_artifact(path, device="cuda")
    net.cuda()
    x = torch.rand(3, 64, 64, 1, generator=torch.Generator().manual_seed(1))
    out = served(x.numpy())
    with torch.no_grad():
        ref = net(x.cuda().permute(0, 3, 1, 2))["logits"].permute(0, 2, 3, 1)
    assert out["logits"].device.type == "cuda" and out["pred"].dtype == torch.int32
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * float(ref.abs().max())
    torch.testing.assert_close(out["logits"], ref, rtol=0, atol=tol)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    assert torch.equal(out["pred"].long()[clear], ref.argmax(dim=-1)[clear])


# ------------------------------------------------------------------ the effect study
@pytest.mark.slow
def test_effect_study_on_the_card(cuda):
    """The float32 effect study (`spcl_torch.scripts.effect_study`) through
    its orchestrator on the card: the seven arms on the seeds of spcl_tpu's
    round-5 table (10-50 for scratch, spsoft_clean, plain_corrupt and
    spsoft_corrupt; 10-30 for plain_clean, sp_clean and sp_corrupt), one
    worker process per run, three at a time, every record written anew;
    then the gate: each arm's mean best val DSC within 3 combined standard
    errors of spcl_tpu's (RESULTS.md:502-510). Marked slow: tier-1 (-m 'not
    slow') never runs it. About 15-25 minutes on one H100; the records stay
    under runs/effect_study_torch/ for the probe and `--collect`."""
    from spcl_torch.scripts import effect_study as es

    five = ("scratch", "spsoft_clean", "plain_corrupt", "spsoft_corrupt")
    three = ("plain_clean", "sp_clean", "sp_corrupt")
    for arms, seeds in ((five, "10,20,30,40,50"), (three, "10,20,30")):
        es.main(["--arms", ",".join(arms), "--seeds", seeds, "--force"])
    res = es.collect()
    assert {a: n for a, (_, _, n) in res["rows"].items()} == \
        {**{a: 5 for a in five}, **{a: 3 for a in three}}
    missed = {a: v for a, v in res["gate"].items() if not v["pass"]}
    assert set(res["gate"]) == set(es.ARMS) and not missed, missed
