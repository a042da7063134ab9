"""Ranks on several hosts, and the Drive cookie retry after a redirect.

- The backend and the card come from the ranks of THIS host
  (`spcl_torch.parallel.mesh.local_layout`, `backend_and_card`): the ranks
  of a run are simulated as threads of this process with
  `torch.cuda.device_count`, `torch.cuda.set_device`, the coordinator's store
  and `init_process_group` replaced by recorders. 2 hosts x 8 cards with 16
  ranks take NCCL with card = local rank; 2 ranks on one card take gloo, both
  on card 0; 4 ranks on a 4-card host without local variables take NCCL (one
  host, as before); hosts that would choose differently raise on every rank;
  `rank_device` names the card chosen, also for ranks that joined on the
  CPU and then train on CUDA, and for a group the caller formed itself
  (from the local variables), whatever card is current.
- `spawn_local` sets the local variables in its ranks.
- `Trainer.mesh: auto` inside a rank process asks for every rank of the run
  (SPCL_NUM_PROCESSES), as spcl_tpu's `jax.devices()` spans every process;
  outside one it stays one rank per visible card.
- spcl_torch's `gdrive_opener` against a local copy of spcl_tpu's Drive
  fixture (tests/test_ioutils.py), served on 127.0.0.1 only: the three flows,
  and the cookie and form flows after a redirect from `localhost` to
  `127.0.0.1`, where the confirm request must reach the host after the
  redirect.
"""
import threading

import pytest
import torch
import torch.distributed as dist

from spcl_torch.data import ioutils
from spcl_torch.parallel import mesh
from spcl_torch.parallel.mesh import spawn_local

import torch_parallel_workers as workers

LOCAL_VARS = (mesh.ENV_LOCAL_RANK, mesh.ENV_LOCAL_WORLD_SIZE)
RUN_VARS = (mesh.ENV_COORDINATOR, mesh.ENV_NUM_PROCESSES, mesh.ENV_PROCESS_ID) + LOCAL_VARS


@pytest.fixture(autouse=True)
def _no_run_environment(monkeypatch):
    for k in RUN_VARS:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------------ simulated hosts
class _Store:
    """The coordinator's key-value store in one process: `get` waits for
    the key, as `torch.distributed.TCPStore.get` does."""

    def __init__(self):
        self._data, self._cv = {}, threading.Condition()

    def set(self, key, value):
        with self._cv:
            self._data[key] = value
            self._cv.notify_all()

    def get(self, key):
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._data, timeout=20.0):
                raise TimeoutError(key)
            return self._data[key]


class _ThreadJoined(threading.local):
    layout = None


def _run_hosts(monkeypatch, hosts, *, local_vars=True, device="cuda"):
    """Start the ranks of `hosts` ([(cards, ranks on that host)], ranks
    numbered host by host) as threads through
    `mesh.initialize_distributed`; returns per rank {"backend", "card",
    "device", "cuda_device"} (the recorded `init_process_group` backend, the
    card made current, `rank_device(device)`, `rank_device("cuda")` where the
    host has cards) or {"error": the exception}."""
    n = sum(r for _, r in hosts)
    here = threading.local()
    store = _Store()
    lock = threading.Lock()
    groups = {}

    def init_process_group(backend, *, store, world_size, rank, timeout):
        assert world_size == n and isinstance(store, _Store)
        with lock:
            groups[rank] = backend
        here.joined = True

    def set_device(card):
        here.card = card

    monkeypatch.setattr(torch.cuda, "device_count", lambda: here.cards)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: here.card)
    monkeypatch.setattr(mesh.socket, "gethostname", lambda: here.host)
    monkeypatch.setattr(mesh.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(mesh.dist, "TCPStore", lambda *a, **k: store)
    monkeypatch.setattr(mesh, "active", lambda: hasattr(here, "joined"))
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(mesh, "_JOINED", _ThreadJoined())  # one process per thread

    out = {}

    def rank_main(r, h, cards, local_rank, local_world):
        here.cards, here.host, here.card = cards, f"host{h}", None
        try:
            kw = dict(local_rank=local_rank, local_world_size=local_world) if local_vars else {}
            world = mesh.initialize_distributed("host0:29500", n, r, device=device,
                                                timeout_s=30.0, **kw)
            res = {"world": world, "card": here.card, "device": mesh.rank_device(device),
                   "cuda_device": mesh.rank_device("cuda") if cards else None}
        except (RuntimeError, ValueError) as e:
            res = {"error": e}
        with lock:
            out[r] = res

    threads, r = [], 0
    for h, (cards, ranks) in enumerate(hosts):
        for lr in range(ranks):
            threads.append(threading.Thread(target=rank_main, args=(r, h, cards, lr, ranks)))
            r += 1
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    for r, res in out.items():
        if "error" not in res:
            res["backend"] = groups[r]
    return [out[r] for r in range(n)]


def test_two_hosts_of_eight_cards_take_nccl_with_card_local_rank(monkeypatch):
    ranks = _run_hosts(monkeypatch, [(8, 8), (8, 8)])
    assert [r["backend"] for r in ranks] == ["nccl"] * 16
    assert [r["card"] for r in ranks] == list(range(8)) * 2
    assert [r["device"] for r in ranks] == [torch.device("cuda", c) for c in list(range(8)) * 2]
    assert all(r["world"] == 16 for r in ranks)


def test_two_ranks_on_one_card_take_gloo(monkeypatch):
    ranks = _run_hosts(monkeypatch, [(1, 2)])
    assert [(r["backend"], r["card"], r["device"]) for r in ranks] \
        == [("gloo", 0, torch.device("cuda", 0))] * 2


def test_one_host_without_local_variables_is_unchanged(monkeypatch):
    ranks = _run_hosts(monkeypatch, [(4, 4)], local_vars=False)
    assert [(r["backend"], r["card"]) for r in ranks] == [("nccl", c) for c in range(4)]
    # six ranks on those four cards share them: gloo, cards 0 1 2 3 0 1
    ranks = _run_hosts(monkeypatch, [(4, 6)], local_vars=False)
    assert [(r["backend"], r["card"]) for r in ranks] == [("gloo", c % 4) for c in range(6)]


def test_cpu_ranks_take_gloo_and_no_card(monkeypatch):
    ranks = _run_hosts(monkeypatch, [(0, 2), (0, 2)], device="cpu")
    assert [(r["backend"], r["card"], r["device"]) for r in ranks] \
        == [("gloo", None, torch.device("cpu"))] * 4


def test_ranks_joined_on_the_cpu_train_on_their_local_card(monkeypatch):
    # the group is gloo without a card; a trainer on "cuda" then takes card
    # local rank, not whichever card is current (none was set)
    ranks = _run_hosts(monkeypatch, [(2, 2), (2, 2)], device="cpu")
    assert [(r["backend"], r["card"]) for r in ranks] == [("gloo", None)] * 4
    assert [r["cuda_device"] for r in ranks] == [torch.device("cuda", c) for c in (0, 1, 0, 1)]


@pytest.mark.parametrize("local_vars,want", [(True, [0, 1, 2, 0, 1, 2]),
                                             (False, [0, 1, 2, 3, 0, 1])])
def test_rank_device_in_a_group_the_caller_formed(monkeypatch, local_vars, want):
    # 2 hosts x 3 ranks on 4 cards each, joined by the caller's own
    # init_process_group: the card comes from SPCL_LOCAL_RANK, or without the
    # local variables from the rank (one host)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group=None: 6)
    got = []
    for r in range(6):
        monkeypatch.setattr(mesh.dist, "get_rank", lambda group=None, r=r: r)
        if local_vars:
            monkeypatch.setenv(mesh.ENV_LOCAL_RANK, str(r % 3))
            monkeypatch.setenv(mesh.ENV_LOCAL_WORLD_SIZE, "3")
        got.append(mesh.rank_device("cuda"))
    assert got == [torch.device("cuda", c) for c in want]
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_hosts_that_choose_differently_raise_on_every_rank(monkeypatch):
    # host0: 8 ranks on 8 cards (nccl); host1: 8 ranks on 4 cards (gloo)
    ranks = _run_hosts(monkeypatch, [(8, 8), (4, 8)])
    assert all("error" in r for r in ranks)
    msg = str(ranks[0]["error"])
    assert "different backends" in msg and "gloo: rank 8 on host1" in msg \
        and "nccl: rank 0 on host0" in msg


def test_local_layout_from_the_environment(monkeypatch):
    assert mesh.local_layout(11, 16) == (11, 16)          # one host
    monkeypatch.setenv(mesh.ENV_LOCAL_RANK, "3")
    with pytest.raises(ValueError, match="or neither"):
        mesh.local_layout(11, 16)
    monkeypatch.setenv(mesh.ENV_LOCAL_WORLD_SIZE, "8")
    assert mesh.local_layout(11, 16) == (3, 8)
    monkeypatch.setenv(mesh.ENV_LOCAL_WORLD_SIZE, "2")
    with pytest.raises(ValueError, match="is not one of"):
        mesh.local_layout(1, 16)
    monkeypatch.setenv(mesh.ENV_LOCAL_RANK, "1")
    monkeypatch.setenv(mesh.ENV_LOCAL_WORLD_SIZE, "3")
    with pytest.raises(ValueError, match="do not divide"):
        mesh.local_layout(1, 16)
    with pytest.raises(ValueError, match="or neither"):
        mesh.local_layout(0, 2, local_rank=0)


def test_backend_and_card():
    assert mesh.backend_and_card("cpu", 5, 8) == ("gloo", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 8)
        assert mesh.backend_and_card("cuda", 5, 8) == ("nccl", 5)
        assert mesh.backend_and_card("cuda:0", 9, 16) == ("gloo", 1)
        mp.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.backend_and_card("cuda", 0, 1)


# ------------------------------------------------------------------ spawn_local, mesh: auto
def test_spawn_local_sets_the_local_variables():
    ranks = spawn_local(2, workers.env_worker, device="cpu", timeout_s=120.0,
                        collective_timeout_s=60.0)
    for r, got in enumerate(ranks):
        env = got["env"]
        assert env[mesh.ENV_LOCAL_RANK] == str(r) and env[mesh.ENV_LOCAL_WORLD_SIZE] == "2"
        assert env[mesh.ENV_PROCESS_ID] == str(r) and env[mesh.ENV_NUM_PROCESSES] == "2"
        assert (got["rank"], got["world"], tuple(got["layout"])) == (r, 2, (r, 2))
        # inside a rank, `mesh: auto` is the run's two ranks, on "cpu" and "cuda"
        assert got["auto"] == [2, 2]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_inside_a_rank_process_is_the_run(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv(mesh.ENV_COORDINATOR, "host0:29500")
    monkeypatch.setenv(mesh.ENV_NUM_PROCESSES, "16")
    monkeypatch.setenv(mesh.ENV_PROCESS_ID, "11")
    assert mesh.is_rank_process()
    assert [mesh.requested_ranks(s, device) for s in ("auto", "AUTO", True, 0, None, 4)] \
        == [16, 16, 16, 1, 1, 4]


def test_auto_outside_a_rank_process_is_one_per_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert not mesh.is_rank_process()
    assert mesh.requested_ranks("auto", "cuda") == 4
    assert mesh.requested_ranks("auto", "cpu") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert mesh.requested_ranks(True, "cuda") == 1
    assert not dist.is_initialized()


# ------------------------------------------------------------------ Drive fixture (C14)
class _DriveFixture:
    """Local HTTP server mimicking Google Drive's download flows, copied from
    spcl_tpu's tests/test_ioutils.py and bound to 127.0.0.1 only: direct
    bytes; the hidden-form interstitial; the legacy download_warning cookie.
    With `redirect`, a request that names the server `localhost` is sent
    on to `127.0.0.1` (as Drive sends uc requests on to another host), and
    only `127.0.0.1` serves the file; a confirm sent to `localhost` gets the
    interstitial again."""

    def __init__(self, payload: bytes, flow: str, redirect: bool = False):
        import http.server
        fixture = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                path = urlparse(self.path).path
                host = self.headers.get("Host", "").split(":")[0]
                fixture.requests.append((host, self.path))
                if fixture.redirect and host == "localhost":
                    if q.get("confirm"):
                        return self._html("<html>virus scan warning, no form</html>")
                    self.send_response(302)
                    self.send_header("Location", f"{fixture.target}{self.path}")
                    self.end_headers()
                    return None
                if path == "/uc" and fixture.flow == "direct":
                    return self._bytes()
                if path == "/uc" and fixture.flow == "cookie":
                    if q.get("confirm"):
                        return self._bytes()
                    return self._html(
                        "<html>virus scan warning, no form</html>",
                        cookie="download_warning_123=tok42; Path=/")
                if path == "/uc":  # form flow
                    return self._html(
                        '<html><form id="download-form" '
                        'action="/download" method="get">'
                        '<input type="hidden" name="id" value="FILEID">'
                        '<input type="hidden" name="export" value="download">'
                        '<input type="hidden" name="confirm" value="t">'
                        '<input type="hidden" name="uuid" value="u-1">'
                        "</form></html>")
                if path == "/download" and q.get("confirm") == ["t"] \
                        and q.get("uuid") == ["u-1"]:
                    return self._bytes()
                self.send_response(404)
                self.end_headers()
                return None

            def _bytes(self):
                self.send_response(200)
                self.send_header("Content-Type", "application/zip")
                self.end_headers()
                self.wfile.write(fixture.payload)

            def _html(self, body: str, cookie=None):
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                if cookie:
                    self.send_header("Set-Cookie", cookie)
                self.end_headers()
                self.wfile.write(body.encode())

        self.payload = payload
        self.flow = flow
        self.redirect = redirect
        self.requests = []
        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        port = self.server.server_port
        self.target = f"http://127.0.0.1:{port}"
        self.base = f"http://localhost:{port}" if redirect else self.target

    def close(self):
        self.server.shutdown()
        self.server.server_close()


PAYLOAD = b"PK-fake-zip-bytes" * 64


@pytest.mark.parametrize("flow", ["direct", "form", "cookie"])
def test_gdrive_opener_flows(tmp_path, flow):
    fx = _DriveFixture(PAYLOAD, flow)
    try:
        dest = tmp_path / "f.zip"
        ioutils.gdrive_opener("https://drive.google.com/uc?id=FILEID", dest, _base=fx.base)
        assert dest.read_bytes() == PAYLOAD
        assert len(fx.requests) == (1 if flow == "direct" else 2), fx.requests
    finally:
        fx.close()


@pytest.mark.parametrize("flow", ["form", "cookie"])
def test_gdrive_confirm_goes_to_the_host_after_the_redirect(tmp_path, flow):
    fx = _DriveFixture(PAYLOAD, flow, redirect=True)
    try:
        dest = tmp_path / "f.zip"
        ioutils.gdrive_opener("https://drive.google.com/uc?id=FILEID", dest, _base=fx.base)
        assert dest.read_bytes() == PAYLOAD
        hosts = [h for h, _ in fx.requests]
        # the first request, its redirect, then the confirm at 127.0.0.1 only
        assert hosts == ["localhost", "127.0.0.1", "127.0.0.1"], fx.requests
        confirm = fx.requests[-1][1]
        assert ("confirm=tok42" if flow == "cookie" else "uuid=u-1") in confirm, fx.requests
    finally:
        fx.close()
