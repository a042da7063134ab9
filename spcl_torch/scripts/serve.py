#!/usr/bin/env python
"""Serve an exported artifact over HTTP (spcl_torch/serving.py::make_http_server).

    python -m spcl_torch.scripts.export_model runs/sp/ft/best.ckpt model.spclt --size 224
    python -m spcl_torch.scripts.serve model.spclt --port 8000 --warmup 8 [--device cuda]

    curl -s localhost:8000/meta
    python - <<'PY'
    import io, urllib.request, numpy as np
    x = np.random.rand(8, 224, 224, 1).astype(np.float32)
    buf = io.BytesIO(); np.save(buf, x)
    r = urllib.request.urlopen(urllib.request.Request(
        "http://localhost:8000/predict", data=buf.getvalue(), method="POST"))
    print(np.load(io.BytesIO(r.read())).shape)   # (8, 224, 224) int32 labels
    PY

The server needs torch and numpy only. The artifact is device-neutral: it is
moved to --device (default cuda) at load, and asking for cuda without a card
fails. `--warmup B` runs one batch of B on the server's device thread before
accepting traffic.
"""
import argparse

import numpy as np

from spcl_torch.serving import make_http_server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=0, metavar="B",
                    help="run one batch of B before serving")
    args = ap.parse_args(argv)

    server = make_http_server(args.artifact, host=args.host, port=args.port,
                              device=args.device)
    meta = server.served_model.meta
    if args.warmup:
        shape = [int(d) if d.isdigit() else args.warmup for d in meta["input_shape"]]
        server.predict(np.zeros(shape, np.float32))
        print(f"warmed up batch={shape[0]}", flush=True)
    print(f"serving {args.artifact} ({meta.get('num_classes', '?')} classes, "
          f"input {meta['input_shape']}) on {args.device}, {args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
