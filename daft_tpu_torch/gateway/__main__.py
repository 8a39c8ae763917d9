"""``python -m daft_tpu_torch.gateway``: the gateway as a standalone server
(counterpart of daft_tpu/gateway/__main__.py).

    python -m daft_tpu_torch.gateway --port 8642 --demo-rows 200000 [--device cpu]

Prints ``gateway listening on HOST:PORT`` once the socket is bound (tests and
scripts read the chosen port from it when --port 0), then serves until
SIGINT/SIGTERM. ``--demo-rows N`` registers a deterministic demo table ``t``
(k = i % 601, v = float(i % 8191), w = i % 97): the same rows on every
launch give the same content fingerprints, so a relaunched gateway resumes
its predecessor's committed checkpoints. ``--device`` (the port's own flag;
``ExecutionConfig.device`` has no environment variable) sets where its
queries' device stages run, "cuda" by default: with no card they fail
unless "cpu" is asked for.
"""

from __future__ import annotations

import argparse
import signal
import threading


def _demo_table(rows: int):
    import numpy as np

    import daft_tpu_torch as dt

    i = np.arange(rows, dtype=np.int64)
    return dt.from_pydict({"k": i % 601, "v": (i % 8191).astype(np.float64), "w": i % 97})


def main(argv=None) -> int:
    from ..config import set_execution_config
    from .server import GatewayServer

    p = argparse.ArgumentParser(prog="python -m daft_tpu_torch.gateway",
                                description="daft_tpu_torch serving gateway (wire protocol "
                                            "over TCP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="bind port (0 = pick a free port; printed on stdout)")
    p.add_argument("--demo-rows", type=int, default=0, metavar="N",
                   help="register a deterministic N-row demo table 't'")
    p.add_argument("--max-concurrent", type=int, default=None,
                   help="serving worker threads (default: ExecutionConfig)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the queries' device stages run (default cuda)")
    args = p.parse_args(argv)

    set_execution_config(device=args.device)
    tables = {"t": _demo_table(args.demo_rows)} if args.demo_rows > 0 else None
    server = GatewayServer(host=args.host, port=args.port, tables=tables,
                           max_concurrent=args.max_concurrent)
    server.start()
    print(f"gateway listening on {server.host}:{server.port}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
