"""bf16 edge inputs of the stage's BatchNorm + ReLU, made with numpy from a
seed: channels whose y0 = z0*inv + shift is exactly +0 or -0.0 (the ReLU
mask [y0 >= 0] passes them), a tiny negative (masked: a float32 subnormal
that bf16 keeps, one that rounds to -0.0 in bf16, a normal), or halfway
between two bf16 values (a0 = bf16(relu(y0)) rounds to even), beside
ordinary channels; and inputs of the BatchNorm backward that land on bf16
ties (`bn_bwd_ties`). Shared by tests/test_torch_port_cuda.py (the kernels
on the card) and tests/test_torch_bf16_edges.py (the plain versions against
spcl_tpu); imports neither torch nor jax."""
import numpy as np

# (name, inv, shift, the z0 that hits the edge, y0 there)
EDGES = (
    ("zero", 1.5, -1.125, 0.75, 0.0),
    ("minus zero", 1.0, -0.0, -0.0, -0.0),
    ("subnormal", 1.0, -2.0 ** -130, 0.0, -2.0 ** -130),
    ("to -0 in bf16", 1.0, -2.0 ** -140, 0.0, -2.0 ** -140),
    ("tiny normal", 1.0, -2.0 ** -120, 0.0, -2.0 ** -120),
    ("tie down", 1.0, 2.0 ** -8, 1.0, 1.0 + 2.0 ** -8),
    ("tie up", 1.0, 2.0 ** -8, 1.0 + 2.0 ** -7, 1.0 + 3 * 2.0 ** -8),
)
# the edges whose y0 is a float32 subnormal: XLA:CPU, like the TPU, flushes
# it to 0, so spcl_tpu's mask passes where the port's (and the card's) masks
FLUSHED = ("subnormal", "to -0 in bf16")


def to_bf16(x):
    """float32 array -> the nearest bf16 values (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.astype(np.uint32).view(np.float32)


def role(k):
    """The edge of channel k (EDGES[k % 8]), or None for an ordinary one."""
    return EDGES[k % 8] if k % 8 < len(EDGES) else None


def pass_inputs(b, h, w, c, seed):
    """(z0, coef, dz1, w1) as float32 numpy arrays for dwprev / bnconv: z0
    and dz1 [b, h, w, c] hold bf16 values; coef [2, c] = (inv, shift) with
    channel k at `role(k)`; half the pixels of an edge channel hold its edge
    z0, the rest random bf16 values."""
    rng = np.random.RandomState(seed)
    z0 = to_bf16(rng.randn(b, h, w, c).astype(np.float32))
    inv = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    shift = (0.1 * rng.randn(c)).astype(np.float32)
    hit = rng.rand(b, h, w, c) < 0.5
    for k in range(c):
        edge = role(k)
        if edge is not None:
            _, inv[k], shift[k], z_hit, _ = edge
            z0[..., k] = np.where(hit[..., k], np.float32(z_hit), z0[..., k])
    dz1 = to_bf16(rng.randn(b, h, w, c).astype(np.float32))
    w1 = (rng.randn(3, 3, c, c) * (9 * c) ** -0.5).astype(np.float32)
    return z0, np.stack([inv, shift]).astype(np.float32), dz1, w1


def bn_bwd_ties(b, h, w, c, seed):
    """(dy, z, dcoef) as float32 numpy arrays, dy and z [b, h, w, c] holding
    bf16 values, dcoef [3, c] = (c0, c1, c2), on which the BatchNorm backward
    in the plain order, (c0*dy + c1) + c2*z with each operation rounded to
    float32, lands exactly halfway between two bf16 values, while the fused
    order c0*dy + (c2*z + c1) (two FMAs) lands one float32 ulp above it.

    Channel k has c0 = 2^e (e = k % 5 - 2), c1 = 2^(e-8) + 2^(e-24) and
    c2 = 2^(e-24); dy holds bf16 values in [1, 2) and z = 1, so c0*dy and
    c2*z are exact. Plain: c0*dy + c1 is a float32 tie that rounds to even,
    c0*dy + 2^(e-8), and adding 2^(e-24) ties the same way. Fused: c2*z + c1
    = 2^(e-8) + 2^(e-23) exactly, and c0*dy plus that is exact too. The
    float32 results always differ; rounded to bf16 (ulp 2^(e-7)), the plain
    one goes to even and the fused one up, so they differ wherever dy's last
    bf16 bit is 0, about half the elements. The plain values have at most 9
    significant bits: one TF32 or bf16 operand holds them exactly."""
    rng = np.random.RandomState(seed)
    dy = (1.0 + rng.randint(0, 128, size=(b, h, w, c)) / 128.0).astype(np.float32)
    e = (np.arange(c) % 5 - 2).astype(np.float64)
    dcoef = np.stack([2.0 ** e, 2.0 ** (e - 8) + 2.0 ** (e - 24), 2.0 ** (e - 24)])
    return dy, np.ones_like(dy), dcoef.astype(np.float32)


def fused_order(dy, z, dcoef):
    """c0*dy + (c2*z + c1) in float32 numpy: the two FMAs' result on
    `bn_bwd_ties` inputs, where both products are exact."""
    c0, c1, c2 = dcoef
    assert np.array_equal((c0 * dy).astype(np.float64), c0.astype(np.float64) * dy)
    assert np.array_equal((c2 * z).astype(np.float64), c2.astype(np.float64) * z)
    return (c0 * dy + (c2 * z + c1)).astype(np.float32)
