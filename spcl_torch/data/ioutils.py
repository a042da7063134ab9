"""Dataset archive ingestion: fetch -> verify -> extract -> locate.

The port's own copy of `spcl_tpu/data/ioutils.py` (host code, no torch).
Capability parity with the reference's download machinery
(contrastyou/data/dataset/_ioutils.py:39-192: gdown/urllib fetch, md5
integrity check, zip/tar/gz extraction, idempotent "folder already there"
short-circuit), redesigned as a small functional layer:

- the network fetch is an injectable ``opener(url, dest_path)`` callable, so
  the whole pipeline is testable offline against a locally built archive and
  a networked host can plug in urllib/gdown without new framework code;
- extraction and hashing stream (constant memory) and extraction is
  tar-safetied (no path traversal);
- `prepare_dataset` is the one entry point: given a dataset key from
  ``constants.DOWNLOAD_SPECS`` it returns the extracted dataset directory,
  fetching + verifying + extracting only what is missing.

Zero-egress environments simply never call the default opener: point
`prepare_dataset` at a directory that already holds the folder or the
archive (e.g. hand-copied), or pass a custom opener.
"""
from __future__ import annotations

import gzip
import hashlib
import shutil
import tarfile
import urllib.request
import zipfile
from pathlib import Path
from typing import Callable, Optional

from ..constants import DOWNLOAD_SPECS

Opener = Callable[[str, Path], None]

_CHUNK = 1 << 20


def calculate_md5(path: str | Path) -> str:
    """Streaming md5 of a file (constant memory)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def check_integrity(path: str | Path, md5: Optional[str] = None) -> bool:
    """True iff `path` is a file and (when `md5` is given) hashes to it."""
    p = Path(path)
    if not p.is_file():
        return False
    return md5 is None or calculate_md5(p) == md5.lower()


def _gdrive_file_id(url: str) -> Optional[str]:
    import re
    for pat in (r"[?&]id=([\w-]+)", r"/file/d/([\w-]+)", r"/uc\?.*id=([\w-]+)"):
        m = re.search(pat, url)
        if m:
            return m.group(1)
    return None


def _parse_gdrive_confirm_form(html: str):
    """(action_url, params) of Drive's 'can't scan for viruses' interstitial.
    Modern Drive serves a <form action=...usercontent...> whose hidden inputs
    (id/export/confirm/uuid...) must be echoed back; older flows instead set
    a download_warning cookie handled by the caller."""
    import re
    m = re.search(r'<form[^>]+action="([^"]+)"', html)
    if not m:
        return None, {}
    action = m.group(1).replace("&amp;", "&")
    params = dict(re.findall(
        r'<input[^>]+name="([^"]+)"[^>]+value="([^"]*)"', html))
    return action, params


def gdrive_opener(url: str, dest: Path, _base: Optional[str] = None) -> None:
    """Google-Drive fetch with the confirm-token/cookie dance the reference
    delegates to gdown (contrastyou/data/dataset/_ioutils.py:39-63) —
    large files get an HTML interstitial instead of bytes; the real download
    needs the hidden-form params (or the legacy download_warning cookie)
    echoed back on a cookie-carrying session.

    `_base` overrides the drive host for tests (a local fixture server
    mimicking the redirect flow)."""
    import http.cookiejar
    import urllib.parse

    file_id = _gdrive_file_id(url)
    base = _base or "https://drive.google.com"
    first = f"{base}/uc?export=download&id={file_id}" if file_id else url
    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))
    opener.addheaders = [("User-Agent", "spcl_torch/ioutils")]

    def fetch(u):
        return opener.open(u, timeout=60)

    r = fetch(first)
    ctype = r.headers.get("Content-Type", "")
    if "text/html" not in ctype:
        with r, open(dest, "wb") as f:
            shutil.copyfileobj(r, f, _CHUNK)
        return
    html = r.read().decode("utf-8", "replace")
    r.close()
    # legacy cookie flow: retry the uc endpoint with &confirm=<token>
    token = next((c.value for c in jar if c.name.startswith("download_warning")),
                 None)
    if token:
        nxt = f"{first}&confirm={token}"
    else:
        action, params = _parse_gdrive_confirm_form(html)
        if action is None:
            raise RuntimeError(
                f"Google Drive returned HTML without a confirm form for "
                f"{url} — file may be private, removed, or quota-limited")
        # Drive's interstitial may use a relative action (e.g. "/uc?...");
        # resolve against the URL that served the form, not just the
        # test-only _base override.
        action = urllib.parse.urljoin(getattr(r, "url", None) or first, action)
        nxt = action + ("&" if "?" in action else "?") + \
            urllib.parse.urlencode(params)
    r2 = fetch(nxt)
    if "text/html" in r2.headers.get("Content-Type", ""):
        r2.close()
        raise RuntimeError(f"Google Drive confirm flow failed for {url}")
    with r2, open(dest, "wb") as f:
        shutil.copyfileobj(r2, f, _CHUNK)


def default_opener(url: str, dest: Path) -> None:
    """urllib fetch; Google-Drive links (the reference's hosting) route
    through the confirm-token flow (`gdrive_opener`). On a host without
    network access the fetch fails and raises with a pointer to the offline
    path."""
    try:
        if "drive.google.com" in url:
            gdrive_opener(url, dest)
            return
        with urllib.request.urlopen(url) as r, open(dest, "wb") as f:  # noqa: S310
            shutil.copyfileobj(r, f, _CHUNK)
    except Exception as e:  # pragma: no cover - network-dependent
        raise RuntimeError(
            f"could not fetch {url}: {e}. On an offline host, place the "
            f"archive at {dest} (or the extracted folder next to it) and "
            f"re-run; or pass a custom opener (e.g. gdown.download).") from e


def download_url(url: str, root: str | Path, filename: str,
                 md5: Optional[str] = None,
                 opener: Opener = default_opener) -> Path:
    """Fetch `url` into `<root>/<filename>` unless an intact copy exists.

    Reference behavior parity (_ioutils.py:65-105): skip when the local file
    passes the integrity check; verify md5 after fetching; raise on corrupt.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    dest = root / filename
    if check_integrity(dest, md5):
        return dest
    opener(url, dest)
    if not check_integrity(dest, md5):
        raise RuntimeError(
            f"{dest} failed the md5 integrity check after download "
            f"(expected {md5}); delete it and retry")
    return dest


def _safe_extract_tar(tar: tarfile.TarFile, to_path: Path) -> None:
    # data filter (py>=3.12 default-able) rejects absolute paths/../ members
    if hasattr(tarfile, "data_filter"):
        tar.extractall(to_path, filter="data")
    else:  # pragma: no cover - old interpreters
        base = to_path.resolve()
        for m in tar.getmembers():
            if not (base / m.name).resolve().is_relative_to(base):
                raise RuntimeError(f"unsafe tar member path: {m.name}")
        tar.extractall(to_path)


def extract_archive(from_path: str | Path, to_path: Optional[str | Path] = None,
                    remove_finished: bool = False) -> Path:
    """Extract zip / tar(.gz|.xz|.bz2) / lone .gz into `to_path`.

    Same format coverage as the reference (_ioutils.py:107-137), dispatched
    on suffixes; returns `to_path`."""
    src = Path(from_path)
    out = Path(to_path) if to_path is not None else src.parent
    out.mkdir(parents=True, exist_ok=True)
    name = src.name.lower()
    if name.endswith(".zip"):
        with zipfile.ZipFile(src) as z:
            z.extractall(out)
    elif name.endswith((".tar", ".tar.gz", ".tgz", ".tar.xz", ".tar.bz2")):
        with tarfile.open(src, "r:*") as tar:
            _safe_extract_tar(tar, out)
    elif name.endswith(".gz"):
        target = out / src.name[:-3]
        with gzip.open(src, "rb") as zf, open(target, "wb") as f:
            shutil.copyfileobj(zf, f, _CHUNK)
    else:
        raise ValueError(f"unsupported archive format: {src.name}")
    if remove_finished:
        src.unlink()
    return out


def prepare_dataset(name: str, root_dir: str | Path,
                    opener: Opener = default_opener,
                    md5: Optional[str] = None) -> Path:
    """Materialize dataset `name` under `root_dir`; return its folder.

    Mirrors the reference's `downloading()` contract
    (_ioutils.py:184-192 + acdc.py:14-18): if `<root>/<folder_name>` exists
    it is used as-is; else the archive is fetched (skipped when a verified
    local copy sits at `<root>/<zip_name>`) and extracted in place.

    md5 overrides the spec's pin (the reference ships none).
    """
    try:
        spec = DOWNLOAD_SPECS[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DOWNLOAD_SPECS)}") from None
    root = Path(root_dir)
    folder = root / spec["folder_name"]
    if folder.is_dir():
        return folder
    md5 = md5 if md5 is not None else spec["md5"]
    archive = download_url(spec["download_link"], root, spec["zip_name"],
                           md5=md5, opener=opener)
    extract_archive(archive, root)
    if not folder.is_dir():
        raise RuntimeError(
            f"{archive.name} extracted but expected folder {folder} is "
            f"missing — archive layout does not match the {name!r} spec")
    return folder
