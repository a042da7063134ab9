"""Inference export for serving: the counterpart of `spcl_tpu/serving.py`.

The eval-mode forward of a trained UNet is exported once with
`torch.export` into one artifact file that holds the program and its
weights: a server runs it with torch and numpy alone, without the model's
source.

- **batch-polymorphic**: the batch dimension is symbolic (`Dim("b")`), so
  one artifact serves any request size; `batch_size` pins it instead;
- **device-neutral**: the weights are stored on the CPU, and `load_artifact`
  moves the program to the device it is asked for (`move_to_device_pass`).
  spcl_tpu lowers for a list of platforms at export time; here nothing about
  the device is fixed at export, so there is no `platforms` argument;
- **one file**: magic | u32 header length | JSON header (input contract,
  class count, torch version, the checkpoint) | the `torch.export.save` bytes.

Input contract (the val geometry of `inference.py` and the eval step):
float32 NHWC in [0, 1], already center-cropped / resized by the host's val
policy. Outputs: {"logits": float32 [b, H, W, C], "pred": int32 [b, H, W]}
(the argmax over the float32 logits, as inference takes it). Under
`Arch.dtype: bfloat16` the UNet computes in bf16 and returns float32 logits.

`make_http_server` serves an artifact over HTTP with the endpoints of
spcl_tpu's server: GET /meta and /healthz, POST /predict with an .npy body.
"""
from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_MAGIC = b"SPCLTOR1"
FORMAT = "spcl_torch.serving/1"


class InferenceModule(nn.Module):
    """The eval-mode UNet on NHWC input: x [b, H, W, C] float32 ->
    {"logits" [b, H, W, classes] float32, "pred" [b, H, W] int32}."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = self.model(x.permute(0, 3, 1, 2))["logits"].permute(0, 2, 3, 1)
        return {"logits": logits, "pred": logits.argmax(dim=-1).to(torch.int32)}


def build_inference_fn(model: nn.Module) -> InferenceModule:
    """The model's eval-mode forward as the artifact runs it (the model is
    put in eval mode: running BatchNorm statistics, the plain path)."""
    return InferenceModule(model).eval()


def export_inference(model: nn.Module, *, height: int, width: int,
                     batch_size: Optional[int] = None) -> torch.export.ExportedProgram:
    """`torch.export` of `build_inference_fn(model)` on the model's device,
    for [b, height, width, model.input_dim] inputs. batch_size None: a
    symbolic batch dimension, one program for any request size; an int pins
    it."""
    device = next(model.parameters()).device
    example = torch.zeros((2 if batch_size is None else int(batch_size), int(height),
                           int(width), int(model.input_dim)), dtype=torch.float32,
                          device=device)
    dynamic = None if batch_size else {"x": {0: torch.export.Dim("b", min=1)}}
    with torch.no_grad():
        return torch.export.export(build_inference_fn(model), (example,),
                                   dynamic_shapes=dynamic)


def _input_spec(program: torch.export.ExportedProgram):
    """(shape with "b" for a symbolic dimension, dtype name) of the input."""
    name = program.graph_signature.user_inputs[0]
    val = next(n for n in program.graph.nodes if n.name == name).meta["val"]
    shape = [str(d) if isinstance(d, int) else "b" for d in val.shape]
    return shape, str(val.dtype).replace("torch.", "")


def save_artifact(path: str, program: torch.export.ExportedProgram,
                  extra_meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the one-file artifact atomically (`training/checkpoint.py::
    safe_save`), its weights on the CPU. Returns the header."""
    from torch.export.passes import move_to_device_pass

    from .training.checkpoint import safe_save

    if any(t.device.type != "cpu" for t in program.state_dict.values()):
        program = move_to_device_pass(program, "cpu")
    shape, dtype = _input_spec(program)
    meta = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "input_shape": shape,
        "input_dtype": dtype,
        "input_contract": "float32 NHWC in [0,1], val-policy cropped",
        "outputs": ["logits f32 [b,H,W,num_classes]", "pred int32 [b,H,W]"],
        **(extra_meta or {}),
    }
    blob = io.BytesIO()
    torch.export.save(program, blob)
    header = json.dumps(meta).encode("utf-8")
    safe_save(_MAGIC + struct.pack("<I", len(header)) + header + blob.getvalue(), path)
    return meta


class ServedModel:
    """A loaded artifact on its device: `meta` (the header) and
    `__call__(x)` -> {"logits", "pred"} tensors on that device."""

    def __init__(self, meta: Dict[str, Any], program: torch.export.ExportedProgram,
                 device: torch.device):
        self.meta = meta
        self.device = device
        self._fn = program.module()

    def __call__(self, x) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        with torch.no_grad():
            return self._fn(x)


def load_artifact(path: str, device="cuda") -> ServedModel:
    """Read an artifact and move its program to `device`; asking for a CUDA
    device where there is none raises."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_artifact: device {device} asked for, but CUDA is "
                           "not available")
    raw = Path(path).read_bytes()
    if raw[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a spcl_torch serving artifact")
    off = len(_MAGIC)
    (hlen,) = struct.unpack("<I", raw[off: off + 4])
    off += 4
    meta = json.loads(raw[off: off + hlen].decode("utf-8"))
    program = torch.export.load(io.BytesIO(raw[off + hlen:]))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return ServedModel(meta, program, device)


def _prepare_input(x, meta: Dict[str, Any]):
    """Coerce a request array to the artifact's input contract.

    Accepts [H,W], [H,W,C], [B,H,W] or [B,H,W,C]; uint8 scales to [0,1]
    (the pack-time encoding, data/packing.py); floats pass through. Spatial
    dims and channel count must match the artifact; a pinned batch dim must
    match exactly. Returns (x_f32_nhwc, squeeze_batch)."""
    shape = meta["input_shape"]  # e.g. ["b", "224", "224", "1"]
    h, w, c = int(shape[1]), int(shape[2]), int(shape[3])
    x = np.asarray(x)
    squeeze = False
    if x.ndim == 2:
        x, squeeze = x[None, :, :, None], True
    elif x.ndim == 3:
        # [H,W,C] if trailing dim matches channels, else [B,H,W]
        if x.shape[-1] == c and x.shape[0] == h and x.shape[1] == w:
            x, squeeze = x[None], True
        else:
            x = x[..., None]
    if x.ndim != 4 or x.shape[1:] != (h, w, c):
        raise ValueError(f"input shape {x.shape} does not match artifact "
                         f"[b, {h}, {w}, {c}]")
    if shape[0].isdigit() and x.shape[0] != int(shape[0]):
        raise ValueError(f"artifact has pinned batch {shape[0]}; got {x.shape[0]}")
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    return x.astype(np.float32, copy=False), squeeze


def make_http_server(artifact_path: str, host: str = "127.0.0.1", port: int = 8000,
                     device="cuda"):
    """A minimal stdlib HTTP inference host over one artifact on `device`.

    Endpoints:
      GET  /meta      -> artifact header JSON
      GET  /healthz   -> {"ok": true}
      POST /predict   -> body: one ``.npy`` array ([H,W], [H,W,C], [B,H,W]
                         or [B,H,W,C]; uint8 or float). Response: ``.npy``
                         int32 label map, or with ``?outputs=logits`` the
                         f32 logits, or ``?outputs=both`` an ``.npz`` with
                         both. Batch squeezed iff the request was unbatched.
    400 on a bad request, 404 on an unknown route, 500 with the error's text
    when the program fails.

    Requests are parsed in a thread each (ThreadingHTTPServer); the device
    call and the copy back of the outputs asked for run one at a time on one
    long-lived thread (`server.predict(x, keep)`), which also spares each
    request the first call of a new thread into the exported program. Returns
    the server (`served_model` holds the loaded artifact); call
    ``.serve_forever()``, then ``.server_close()``, which also stops the
    device thread (CLI: `python -m spcl_torch.scripts.serve`)."""
    from concurrent.futures import ThreadPoolExecutor
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    served = load_artifact(artifact_path, device)

    class Handler(BaseHTTPRequestHandler):
        # TCP_NODELAY: the headers and the body go out as two writes, and
        # with Nagle's algorithm on the body's last segment waits for the
        # client's delayed ACK (about 40 ms a request on Linux)
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
            self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/meta":
                self._send_json(200, served.meta)
            elif path == "/healthz":
                self._send_json(200, {"ok": True})
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._send_json(404, {"error": f"no route {url.path}"})
                return
            outputs = parse_qs(url.query).get("outputs", ["pred"])[0]
            if outputs not in ("pred", "logits", "both"):
                self._send_json(400, {"error": f"outputs={outputs!r} not in "
                                               "pred|logits|both"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                x = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                x, squeeze = _prepare_input(x, served.meta)
            except Exception as e:  # any malformed request body is the client's
                self._send_json(400, {"error": str(e)})
                return
            keep = ("pred", "logits") if outputs == "both" else (outputs,)
            try:
                res = self.server.predict(x, keep)
            except Exception as e:  # report a failing program instead of dropping the connection
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if squeeze:
                res = {k: v[0] for k, v in res.items()}
            buf = io.BytesIO()
            if outputs == "both":
                np.savez(buf, **res)
            else:
                np.save(buf, res[outputs])
            self._send(200, buf.getvalue(), "application/octet-stream")

    class Server(ThreadingHTTPServer):
        def __init__(self, address):
            super().__init__(address, Handler)
            self.served_model = served  # warm-up and test handle
            self._device_thread = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="spcl-serve")

        def predict(self, x, keep=("pred", "logits")) -> Dict[str, np.ndarray]:
            """The artifact's outputs named in `keep` for x, as host arrays,
            computed on the device thread."""
            def run():
                return {k: v.cpu().numpy() for k, v in served(x).items() if k in keep}
            return self._device_thread.submit(run).result()

        def server_close(self):
            super().server_close()
            self._device_thread.shutdown(wait=True)

    return Server((host, port))


def export_from_checkpoint(checkpoint: str, out_path: str, *, config: Dict,
                           height: int, width: int,
                           batch_size: Optional[int] = None) -> Dict[str, Any]:
    """Checkpoint (a trainer checkpoint or a warm start: anything
    `load_model_state_dict` reads) -> artifact on disk. The UNet is built as
    the entry points build it (`Arch.dtype`, `max_channel`, ...) on the CPU."""
    from .entry.common import build_model_from_config
    from .training.checkpoint import load_model_state_dict

    model = build_model_from_config(config)
    model.load_state_dict(load_model_state_dict(checkpoint), strict=False)
    program = export_inference(model, height=height, width=width, batch_size=batch_size)
    return save_artifact(out_path, program, extra_meta={
        "checkpoint": str(checkpoint),
        "num_classes": int(model.num_classes),
        "max_channel": getattr(model, "max_channel", None),
        "dtype": str(model.dtype).replace("torch.", ""),
    })
