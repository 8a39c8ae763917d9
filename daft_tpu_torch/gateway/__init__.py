"""Gateway: the network front door — wire-protocol serving over TCP
(counterpart of daft_tpu/gateway/).

The serving tier (serving/) makes the warm engine concurrent and
multi-tenant in-process; the gateway puts it on the network without
re-deriving any of it: a length-framed socket protocol (protocol.py) fronts
one ServingSession, so tenant fairness, QoS weights and queue caps, HBM
admission, prepared-plan reuse, and cooperative cancellation all apply
unchanged to remote clients. The wire is the reference's, byte for byte,
its result chunks Arrow IPC streams of the port's own (io/arrow_ipc.py).

    server:  python -m daft_tpu_torch.gateway --port 8642 --demo-rows 200000
             (--device cpu to run its queries on the CPU)
    client:  from daft_tpu_torch.gateway import GatewayClient
             with GatewayClient(host, port, tenant="acme", token=t) as c:
                 print(c.query("SELECT COUNT(*) AS n FROM t"))

What the network layer adds on top of the session (see server.py):

- per-tenant shared-secret auth (``DAFT_TPU_GATEWAY_TOKENS``),
- server-scoped prepared handles that survive reconnects,
- a fingerprint-keyed result cache (``DAFT_TPU_GATEWAY_RESULT_CACHE``)
  with exact source-change invalidation,
- a restartable driver: results checkpoint through the StageCheckpointer
  (checkpoint/stages.py), so a killed-and-relaunched gateway resumes
  committed work from disk instead of recomputing (and never serves a stale
  result — the checkpoint key embeds the source content fingerprints).

Observability: gateway_*/result_cache_* counters on /metrics, a
GatewayQueryRecord per query, the /api/gateway dashboard route, and
flight-recorder ``gateway_error`` / ``cache_thrash`` anomaly triggers that
tools/doctor.py triages from dumps alone.
"""

from .client import GatewayClient
from .protocol import GatewayError, WireError, parse_token_map
from .result_cache import CachedResult, ResultCache
from .server import GatewayServer

__all__ = [
    "CachedResult",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "ResultCache",
    "WireError",
    "parse_token_map",
]
