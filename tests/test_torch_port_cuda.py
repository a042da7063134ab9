"""spcl_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `gpu`: skipped where torch sees no CUDA device
(the kernels have no CPU mode). On the GPU machine, without jax installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py

Tolerance: 2e-4 absolute on the per-row statistics (rowloss, c, log denom,
a — all O(1..10)) and on the loss; 2e-4 x max|dz| on dz. float32 sums run in
another order, and s carries 1/T = 14.3x the dot-product rounding.
"""
import pytest
import torch

from spcl_torch.ops import supcon_cuda as sc

pytestmark = pytest.mark.gpu

D = 256


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the supcon kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sc.build()
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
