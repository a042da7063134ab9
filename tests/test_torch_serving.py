"""Serving with spcl_torch (`spcl_torch/serving.py`, `spcl_torch/scripts/
export_model.py`) against spcl_tpu's (`spcl_tpu/serving.py`), on the CPU.

- The ports of tests/test_serving.py and tests/test_serve_http.py: one
  artifact with a symbolic batch answers two batch sizes; a pinned batch; a
  file that is not an artifact is refused; GET /meta and /healthz; POST
  /predict against the live eval-mode module; uint8 and unbatched requests;
  400 on bad input; `_prepare_input`'s shapes; concurrent requests answered
  each with its own result, the program called on one device thread only.
  The exported program runs the same operations as the live module, so its
  logits are held within 1e-5.
- Parity: the same random weights (spcl_tpu's, transplanted) exported by
  spcl_tpu (`platforms=("cpu",)`) and by the port and served by both HTTP
  servers; the same .npy request bytes give logits within 1e-4 and the same
  `pred` wherever the top two logits are further apart than that.
- bfloat16 (`Arch.dtype`): the port's bf16 export against its live bf16
  module within 2^-7 x max|logits| (the rule bf16 outputs are held to), and
  against spcl_tpu's bf16 export within BF16_VS_JAX_TOL = 5e-3 relative L2,
  and closer to it than spcl_tpu's bf16 export is to its float32 one. That
  bound is looser than tests/test_torch_bf16.py's UNET_TOL (2e-3, the UNet
  to Conv2 with XLA's excess precision off): here the whole UNet runs to the
  logits, and the exported XLA program keeps float32 between fused bf16
  operations where PyTorch rounds after each. Measured on these inputs:
  2.8e-3, against 6.6e-3 between spcl_tpu's bf16 and float32 exports.
- `load_artifact(..., device="cuda")` raises where CUDA is unavailable.
- `python -m spcl_torch.scripts.export_model` from a checkpoint, verifying.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu import serving as jax_serving
from spcl_tpu.models import UNet as JaxUNet
from spcl_torch.models import UNet, unet_state_dict_from_flax
from spcl_torch.scripts import export_model
from spcl_torch.serving import (_prepare_input, export_inference, load_artifact,
                                make_http_server, save_artifact)
from spcl_torch.training import save_checkpoint
from test_torch_port_model import random_flax_unet

SIZE = 32
LIVE_TOL = 1e-5
PARITY_TOL = 1e-4
BF16_REL_TOL = 2.0 ** -7
BF16_VS_JAX_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_hooks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed=0):
    params, stats = random_flax_unet(np.random.default_rng(seed), max_channel=128)
    sd = {k: torch.from_numpy(v) for k, v in unet_state_dict_from_flax(params, stats).items()}
    return params, stats, sd


def _model(sd, dtype=torch.float32):
    net = UNet(input_dim=1, num_classes=4, max_channel=128, dtype=dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _live(net, x):
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))["logits"]
    return out.permute(0, 2, 3, 1).numpy()


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}", t


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(url, arr, query=""):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict" + query, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _pred_equal_away_from_ties(pred, logits, want_pred, tol):
    """pred == want_pred wherever the top two logits differ by more than tol."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


# ------------------------------------------------------------------ artifacts
@pytest.fixture(scope="module")
def net():
    return _model(_weights()[2])


def test_artifact_roundtrip_polymorphic_batch(tmp_path, net):
    path = str(tmp_path / "m.spclt")
    meta = save_artifact(path, export_inference(net, height=SIZE, width=SIZE),
                         extra_meta={"num_classes": 4})
    assert meta["input_shape"] == ["b", str(SIZE), str(SIZE), "1"]
    assert meta["format"] == "spcl_torch.serving/1" and meta["input_dtype"] == "float32"
    served = load_artifact(path, device="cpu")
    assert served.meta["num_classes"] == 4
    rng = np.random.default_rng(0)
    for b in (1, 3, 5):  # one artifact, several batch sizes
        x = rng.random((b, SIZE, SIZE, 1), dtype=np.float32)
        out = served(x)
        ref = _live(net, x)
        np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=0, atol=LIVE_TOL)
        assert out["pred"].dtype == torch.int32
        np.testing.assert_array_equal(out["pred"].numpy(), np.argmax(ref, axis=-1))


def test_pinned_batch_export(tmp_path, net):
    path = str(tmp_path / "m.spclt")
    save_artifact(path, export_inference(net, height=SIZE, width=SIZE, batch_size=2))
    served = load_artifact(path, device="cpu")
    assert served.meta["input_shape"][0] == "2"
    assert tuple(served(np.zeros((2, SIZE, SIZE, 1), np.float32))["pred"].shape) == (2, SIZE, SIZE)


def test_load_rejects_non_artifact(tmp_path):
    bad = tmp_path / "not.spclt"
    bad.write_bytes(b"garbage bytes")
    with pytest.raises(ValueError, match="not a spcl_torch serving artifact"):
        load_artifact(str(bad), device="cpu")
    jax_artifact = tmp_path / "jax.spclx"
    jax_artifact.write_bytes(b"SPCLEXP1" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a spcl_torch serving artifact"):
        load_artifact(str(jax_artifact), device="cpu")


def test_load_on_cuda_raises_without_cuda(tmp_path, net, monkeypatch):
    path = str(tmp_path / "m.spclt")
    save_artifact(path, export_inference(net, height=SIZE, width=SIZE))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_artifact(path, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_http_server(path, port=0, device="cuda")


# ------------------------------------------------------------------ HTTP host
@pytest.fixture(scope="module")
def server_and_model(tmp_path_factory, net):
    path = str(tmp_path_factory.mktemp("art") / "m.spclt")
    save_artifact(path, export_inference(net, height=SIZE, width=SIZE),
                  extra_meta={"num_classes": 4})
    server = make_http_server(path, host="127.0.0.1", port=0, device="cpu")
    url, thread = _serve(server)
    yield url, net
    _stop(server, thread)


def test_meta_and_health(server_and_model):
    url, _ = server_and_model
    with urllib.request.urlopen(url + "/meta", timeout=60) as r:
        meta = json.loads(r.read())
    assert meta["num_classes"] == 4
    assert meta["input_shape"] == ["b", str(SIZE), str(SIZE), "1"]
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        assert json.loads(r.read()) == {"ok": True}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert e.value.code == 404


def test_predict_matches_direct_apply(server_and_model):
    url, net = server_and_model
    x = np.random.default_rng(0).random((3, SIZE, SIZE, 1), dtype=np.float32)
    ref = _live(net, x)

    pred = np.load(io.BytesIO(_post(url, x)))
    assert pred.shape == (3, SIZE, SIZE) and pred.dtype == np.int32
    np.testing.assert_array_equal(pred, np.argmax(ref, axis=-1))

    logits = np.load(io.BytesIO(_post(url, x, "?outputs=logits")))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=LIVE_TOL)

    both = np.load(io.BytesIO(_post(url, x, "?outputs=both")))
    assert set(both.files) == {"pred", "logits"}
    np.testing.assert_array_equal(both["pred"], pred)


def test_predict_coercions(server_and_model):
    """[H,W] uint8 requests: batch squeezed back, uint8 scaled /255 (the
    same answer as the pre-scaled float request)."""
    url, _ = server_and_model
    x8 = np.random.default_rng(1).integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
    pred8 = np.load(io.BytesIO(_post(url, x8)))
    assert pred8.shape == (SIZE, SIZE)
    predf = np.load(io.BytesIO(_post(url, x8.astype(np.float32) / 255.0)))
    np.testing.assert_array_equal(pred8, predf)


def test_predict_rejects_bad_input(server_and_model):
    url, _ = server_and_model
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, np.zeros((2, SIZE + 1, SIZE, 1), np.float32))
    assert e.value.code == 400
    assert "does not match artifact" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, np.zeros((2, SIZE, SIZE, 1), np.float32), "?outputs=junk")
    assert e.value.code == 400
    req = urllib.request.Request(url + "/predict", data=b"not an npy", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_concurrent_requests_run_on_one_device_thread(tmp_path, net):
    """8 clients at once: every answer is its own request's, and every call
    of the program ran on the server's one device thread."""
    path = str(tmp_path / "m.spclt")
    save_artifact(path, export_inference(net, height=SIZE, width=SIZE))
    server = make_http_server(path, port=0, device="cpu")
    fn, threads = server.served_model._fn, set()

    def recording(x):
        threads.add(threading.current_thread().name)
        return fn(x)

    server.served_model._fn = recording
    url, thread = _serve(server)
    xs = [np.random.default_rng(10 + i).random((2, SIZE, SIZE, 1), dtype=np.float32)
          for i in range(8)]
    got = [None] * len(xs)

    def client(i):
        got[i] = np.load(io.BytesIO(_post(url, xs[i])))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients)
    finally:
        _stop(server, thread)
    for x, pred in zip(xs, got):
        np.testing.assert_array_equal(pred, np.argmax(_live(net, x), axis=-1))
    assert len(threads) == 1 and next(iter(threads)).startswith("spcl-serve"), threads


def test_prepare_input_shapes():
    meta = {"input_shape": ["b", "8", "8", "2"]}
    x, squeeze = _prepare_input(np.zeros((8, 8, 2), np.float32), meta)
    assert x.shape == (1, 8, 8, 2) and squeeze  # [H,W,C] -> batched
    x, squeeze = _prepare_input(np.zeros((3, 8, 8), np.float32),
                                {"input_shape": ["b", "8", "8", "1"]})
    assert x.shape == (3, 8, 8, 1) and not squeeze  # [B,H,W] -> channel added
    with pytest.raises(ValueError, match="pinned batch"):
        _prepare_input(np.zeros((3, 8, 8, 2), np.float32),
                       {"input_shape": ["2", "8", "8", "2"]})
    for x in (np.zeros((8, 8, 2), np.float32), np.full((2, 8, 8, 2), 255, np.uint8)):
        want = jax_serving._prepare_input(x, meta)
        got = _prepare_input(x, meta)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].dtype == want[0].dtype


# ------------------------------------------------------------------ against spcl_tpu
def _jax_artifact(path, params, stats, dtype):
    model = JaxUNet(input_dim=1, num_classes=4, max_channel=128, dtype=dtype)
    exported = jax_serving.export_inference(
        model, {"params": params, "batch_stats": stats}, height=SIZE, width=SIZE,
        platforms=("cpu",))
    jax_serving.save_artifact(path, exported, extra_meta={"num_classes": 4})


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """spcl_tpu's and the port's HTTP servers over the same weights, float32
    and bf16: {dtype name: (jax url, port url)}, and the port's live nets."""
    tmp = tmp_path_factory.mktemp("parity")
    params, stats, sd = _weights(seed=1)
    urls, live, running = {}, {}, []
    for name, jdtype, tdtype in (("float32", jnp.float32, torch.float32),
                                 ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        _jax_artifact(str(tmp / f"{name}.spclx"), params, stats, jdtype)
        live[name] = _model(sd, tdtype)
        save_artifact(str(tmp / f"{name}.spclt"),
                      export_inference(live[name], height=SIZE, width=SIZE))
        servers = (jax_serving.make_http_server(str(tmp / f"{name}.spclx"), port=0),
                   make_http_server(str(tmp / f"{name}.spclt"), port=0, device="cpu"))
        pair = []
        for server in servers:
            url, thread = _serve(server)
            running.append((server, thread))
            pair.append(url)
        urls[name] = tuple(pair)
    yield urls, live
    for server, thread in running:
        _stop(server, thread)


def _both(urls, x):
    out = []
    for url in urls:
        both = np.load(io.BytesIO(_post(url, x, "?outputs=both")))
        out.append((both["logits"], both["pred"]))
    return out


def test_served_logits_match_spcl_tpus_server(both_servers):
    urls, _ = both_servers
    rng = np.random.default_rng(2)
    for x in (rng.random((4, SIZE, SIZE, 1), dtype=np.float32),
              rng.integers(0, 256, (2, SIZE, SIZE), dtype=np.uint8)):
        (jl, jp), (pl, pp) = _both(urls["float32"], x)
        assert pl.shape == jl.shape and pp.dtype == jp.dtype == np.int32
        np.testing.assert_allclose(pl, jl, rtol=0, atol=PARITY_TOL)
        _pred_equal_away_from_ties(pp, jl, jp, PARITY_TOL)


def test_bf16_artifact_matches_live_module_and_spcl_tpu(both_servers):
    urls, live = both_servers
    x = np.random.default_rng(3).random((4, SIZE, SIZE, 1), dtype=np.float32)
    (jl, _), (pl, pp) = _both(urls["bfloat16"], x)
    (jl32, _), _ = _both(urls["float32"], x)
    ref = _live(live["bfloat16"], x)
    tol = BF16_REL_TOL * float(np.abs(ref).max())
    np.testing.assert_allclose(pl, ref, rtol=0, atol=tol)
    _pred_equal_away_from_ties(pp, ref, np.argmax(ref, axis=-1), tol)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(pl, jl) <= BF16_VS_JAX_TOL, rel(pl, jl)
    assert rel(pl, jl) < rel(jl, jl32), (rel(pl, jl), rel(jl, jl32))


# ------------------------------------------------------------------ the export CLI
def test_export_cli_from_checkpoint(tmp_path, capsys):
    _, _, sd = _weights(seed=2)
    ckpt = str(tmp_path / "warm.ckpt")
    save_checkpoint(ckpt, {"_model": sd})
    out = str(tmp_path / "m.spclt")
    meta = export_model.main([ckpt, out, "--size", str(SIZE), "--device", "cpu",
                              "--config", "Arch.max_channel=128"])
    assert "verified on cpu" in capsys.readouterr().out
    served = load_artifact(out, device="cpu")
    assert served.meta == meta
    assert meta["checkpoint"] == ckpt and meta["max_channel"] == 128
    assert meta["dtype"] == "float32" and meta["num_classes"] == 4
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 1), dtype=np.float32)
    np.testing.assert_allclose(served(x)["logits"].numpy(), _live(_model(sd), x),
                               rtol=0, atol=LIVE_TOL)
