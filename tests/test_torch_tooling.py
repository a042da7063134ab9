"""spcl_torch's data ingestion and job tooling, and MixUp's Beta draw,
against spcl_tpu's, on the CPU.

- `spcl_torch.data.ioutils`: the local cases of tests/test_ioutils.py
  (archives built in tmp_path, an injected opener; no test fetches from a
  network), plus the Drive helpers that parse URLs and forms.
- `python -m spcl_torch.scripts.pack_dataset --archive`: arrays byte-equal to
  those of `scripts/pack_dataset.py` on the same archive.
- `spcl_torch.scripts.generate_jobs`: for every flavor, spcl_tpu's lines with
  `python <entry>.py` read as `python -m spcl_torch.<entry>`.
- `spcl_torch.scripts.full_schedule.best_score` (the csv module) equal to
  spcl_tpu's (pandas) on a written storage.csv.
- `MixUpHook(alpha)`'s Beta(alpha, alpha) draw at alpha 0.4 and 2.0: 20 000
  draws from a seeded generator pass a KS test against scipy's Beta with
  p > 1e-3, and the same seed gives the same draws; the hook's loss with
  spcl_tpu's lambda and permutation injected equals spcl_tpu's within
  rtol 1e-5, atol 1e-6 (tests/test_torch_semi_hooks.py's tolerance).
"""
import hashlib
import importlib.util
import re
import shutil
import sys
import tarfile
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from spcl_tpu.hooks.mixup import MixUpHook as JaxMixUpHook
from spcl_torch.data import ioutils
from spcl_torch.data.packing import load_packed, pack_png_folder
from spcl_torch.hooks.mixup import MixUpHook, sample_beta
from spcl_torch.scripts import full_schedule, generate_jobs, pack_dataset
from test_ioutils import _build_acdc_zip
from test_torch_semi_hooks import KEY, N_L, TOL, _arrays, _jax_ctx, _port_ctx

REPO = Path(__file__).parents[1]
KS_DRAWS = 20_000
KS_P = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_hooks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    """A module of scripts/ (spcl_tpu's tooling), imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ ioutils
def test_md5_and_integrity(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"spcl" * 1000)
    h = ioutils.calculate_md5(f)
    assert h == hashlib.md5(b"spcl" * 1000).hexdigest()
    assert ioutils.check_integrity(f, h) and ioutils.check_integrity(f, h.upper())
    assert ioutils.check_integrity(f, md5=None)
    assert not ioutils.check_integrity(f, "0" * 32)
    assert not ioutils.check_integrity(tmp_path / "missing.bin")


def test_download_url_skips_verified_and_rejects_corrupt(tmp_path):
    payload = b"archive-bytes"
    calls = []

    def opener(url, dest):
        calls.append(url)
        Path(dest).write_bytes(payload)

    good = hashlib.md5(payload).hexdigest()
    p = ioutils.download_url("fake://x/a.zip", tmp_path, "a.zip", md5=good, opener=opener)
    assert p.read_bytes() == payload and calls == ["fake://x/a.zip"]
    ioutils.download_url("fake://x/a.zip", tmp_path, "a.zip", md5=good, opener=opener)
    assert len(calls) == 1  # a verified local copy short-circuits the fetch
    with pytest.raises(RuntimeError, match="integrity"):
        ioutils.download_url("fake://x/b.zip", tmp_path, "b.zip", md5="0" * 32, opener=opener)


def test_extract_archive_formats(tmp_path):
    src = tmp_path / "tree" / "D"
    (src / "sub").mkdir(parents=True)
    (src / "sub" / "x.txt").write_text("hello")
    ztgt = tmp_path / "D.zip"
    with zipfile.ZipFile(ztgt, "w") as z:
        z.write(src / "sub" / "x.txt", "D/sub/x.txt")
    assert (ioutils.extract_archive(ztgt, tmp_path / "oz") / "D" / "sub" / "x.txt").read_text() \
        == "hello"
    ttgt = tmp_path / "D.tar.gz"
    with tarfile.open(ttgt, "w:gz") as t:
        t.add(src, arcname="D")
    assert (ioutils.extract_archive(ttgt, tmp_path / "ot") / "D" / "sub" / "x.txt").read_text() \
        == "hello"
    with pytest.raises(ValueError, match="unsupported"):
        ioutils.extract_archive(src / "sub" / "x.txt")
    ioutils.extract_archive(ztgt, tmp_path / "oz2", remove_finished=True)
    assert not ztgt.exists()


def test_extract_refuses_tar_path_traversal(tmp_path):
    evil = tmp_path / "evil.tar"
    (tmp_path / "payload.txt").write_text("x")
    with tarfile.open(evil, "w") as t:
        t.add(tmp_path / "payload.txt", arcname="../escaped.txt")
    with pytest.raises(Exception):
        ioutils.extract_archive(evil, tmp_path / "out")
    assert not (tmp_path / "escaped.txt").exists()


def test_prepare_dataset_full_pipeline(tmp_path):
    """fetch (injected) -> md5 -> extract -> folder; idempotent afterwards."""
    zip_path = _build_acdc_zip(tmp_path)
    md5 = ioutils.calculate_md5(zip_path)
    calls = []

    def opener(url, dest):
        calls.append(url)
        shutil.copyfile(zip_path, dest)

    root = tmp_path / "data"
    folder = ioutils.prepare_dataset("acdc", root, opener=opener, md5=md5)
    assert folder == root / "ACDC-all" and folder.is_dir()
    assert len(calls) == 1 and "drive.google.com" in calls[0]
    assert ioutils.prepare_dataset("acdc", root, opener=opener, md5=md5) == folder
    assert len(calls) == 1
    with pytest.raises(RuntimeError, match="integrity"):
        ioutils.prepare_dataset("acdc", tmp_path / "data2", opener=opener, md5="0" * 32)
    with pytest.raises(KeyError, match="unknown dataset"):
        ioutils.prepare_dataset("nope", root)


def test_zip_to_packed_arrays_end_to_end(tmp_path):
    zip_path = _build_acdc_zip(tmp_path)
    folder = ioutils.prepare_dataset("acdc", tmp_path / "data",
                                     opener=lambda url, dest: shutil.copyfile(zip_path, dest),
                                     md5=ioutils.calculate_md5(zip_path))
    ds = pack_png_folder(str(folder), "acdc", mode="train", canvas=64,
                         save_path=str(tmp_path / "acdc_train.npz"))
    assert len(ds) == 3 * 4 and len(ds.unique_scans) == 3
    np.testing.assert_array_equal(ds.images, load_packed(str(tmp_path / "acdc_train.npz")).images)


def test_gdrive_helpers():
    assert ioutils._gdrive_file_id("https://drive.google.com/uc?id=abc_DEF-123") == "abc_DEF-123"
    assert ioutils._gdrive_file_id(
        "https://drive.google.com/file/d/xYz-9/view?usp=sharing") == "xYz-9"
    assert ioutils._gdrive_file_id("https://example.com/data.zip") is None
    action, params = ioutils._parse_gdrive_confirm_form(
        '<form id="f" action="/download?a=1&amp;b=2" method="get">'
        '<input type="hidden" name="id" value="FILEID">'
        '<input type="hidden" name="confirm" value="t"></form>')
    assert action == "/download?a=1&b=2" and params == {"id": "FILEID", "confirm": "t"}
    assert ioutils._parse_gdrive_confirm_form("<html>no form</html>") == (None, {})


# ------------------------------------------------------------------ pack_dataset
def test_pack_dataset_cli_equals_spcl_tpus(tmp_path, monkeypatch):
    zip_path = _build_acdc_zip(tmp_path)
    md5 = ioutils.calculate_md5(zip_path)
    args = ["--archive", str(zip_path), "--md5", md5, "--name", "acdc", "--canvas", "64"]
    pack_dataset.main(args + ["--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["pack_dataset.py"] + args + ["--out", str(tmp_path / "jax")])
    _jax_script("pack_dataset").main()
    for mode, slices in (("train", 12), ("val", 8)):
        with np.load(tmp_path / "port" / f"acdc_{mode}.npz") as got, \
                np.load(tmp_path / "jax" / f"acdc_{mode}.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), k
        assert len(load_packed(str(tmp_path / "port" / f"acdc_{mode}.npz"))) == slices
    with pytest.raises(SystemExit, match="md5"):
        pack_dataset.main(["--archive", str(zip_path), "--md5", "0" * 32, "--name", "acdc",
                           "--out", str(tmp_path / "bad")])


# ------------------------------------------------------------------ generate_jobs
@pytest.mark.parametrize("flavor", generate_jobs.FLAVORS)
def test_generate_jobs_equal_spcl_tpus(flavor, monkeypatch, capsys):
    argv = [flavor, "--data", "prostate", "--seeds", "10", "20", "--save-dir", "runs/g"]
    if flavor == "spinfonce":
        argv += ["--grid", "begin_values=1000,10000", "mode=soft,hard"]
    monkeypatch.setattr(sys, "argv", ["generate_jobs.py"] + argv)
    _jax_script("generate_jobs").main()
    want = capsys.readouterr().out.splitlines()
    got = generate_jobs.main(argv)
    assert capsys.readouterr().out.splitlines() == got
    assert len(got) >= 2
    assert got == [re.sub(r"^python (\w+)\.py ", r"python -m spcl_torch.\1 ", j) for j in want]


# ------------------------------------------------------------------ full_schedule
def test_full_schedule_best_score_without_pandas(tmp_path):
    run = tmp_path / "tra_1"
    run.mkdir()
    (run / "storage.csv").write_text(
        "epoch,tra/sup_loss/mean,val/dice/DSC_mean\n"
        "1,0.9,0.41\n2,0.7,\n3,0.6,nan\n4,0.5,0.4375\n5,0.4,0.43\n")
    want = _jax_script("full_schedule").best_score(run)
    assert full_schedule.best_score(run) == want == 0.4375


# ------------------------------------------------------------------ MixUp's Beta draw
@pytest.mark.parametrize("alpha", [0.4, 2.0])
def test_beta_draws_follow_beta_and_repeat(alpha):
    gen = torch.Generator().manual_seed(1234)
    draws = sample_beta(gen, alpha, alpha, (KS_DRAWS,))
    assert draws.dtype == torch.float32 and draws.shape == (KS_DRAWS,)
    x = draws.numpy().astype(np.float64)
    assert np.all((x >= 0) & (x <= 1))
    p = scipy.stats.kstest(x, scipy.stats.beta(alpha, alpha).cdf).pvalue
    assert p > KS_P, p
    again = sample_beta(torch.Generator().manual_seed(1234), alpha, alpha, (KS_DRAWS,))
    assert torch.equal(draws, again)


def test_mixup_hook_draws_beta_and_keeps_uniform_at_one():
    ctx = _port_ctx(_arrays())
    d = MixUpHook(alpha=0.4).sample(torch.Generator().manual_seed(0), ctx)
    assert d["lam"].shape == () and 0.0 <= float(d["lam"]) <= 1.0
    assert sorted(d["perm"].tolist()) == list(range(2 * N_L))
    # alpha = 1 keeps the U(0, 1) draw, so the stream of every config is unchanged
    one = MixUpHook(alpha=1.0).sample(torch.Generator().manual_seed(0), ctx)
    assert float(one["lam"]) == float(torch.rand((), generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError):
        MixUpHook(alpha=0.0)


@pytest.mark.parametrize("alpha", [0.4, 2.0])
def test_mixup_loss_with_spcl_tpus_draw_matches(alpha):
    a = _arrays()
    jhook, hook = JaxMixUpHook(weight=0.01, alpha=alpha), MixUpHook(weight=0.01, alpha=alpha)
    k_lam, k_perm = jax.random.split(jax.random.fold_in(KEY, 29))  # hooks/mixup.py:29-31
    ctx = _port_ctx(a)
    ctx["draws"] = {hook.name: {
        "lam": torch.tensor(float(jax.random.beta(k_lam, alpha, alpha))),
        "perm": torch.from_numpy(np.array(jax.random.permutation(k_perm, 2 * N_L)))}}
    loss, metrics = hook.loss_fn(ctx, {})
    jloss, jmetrics = jhook.loss_fn(None, _jax_ctx(a, KEY), {})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **TOL)
