"""Fair admission queue (counterpart of daft_tpu/serving/admission.py):
per-tenant weighted round-robin, FIFO within a tenant, with per-tenant
queue-depth caps.

The serving tier's first gate (the second is the HBM admission controller,
``device/residency.py ResidencyManager.admit``). Classic fair-queueing shape:
one FIFO per tenant, served round-robin, so a tenant replaying a 500-query
batch cannot starve an interactive tenant's single query — the interactive
query waits at most one rotation, not 500 slots. Tenants enter the rotation
on their first pending item and leave it when drained; the rotation pointer
survives drains so service order stays fair across bursts.

QoS beyond fairness (the gateway's multi-tenant contract):

- **Weights** — ``DAFT_TPU_TENANT_WEIGHT_<TENANT>`` (tenant name uppercased,
  non-alphanumerics mapped to ``_``; default 1) gives a tenant up to that
  many services per rotation visit. A weight-3 tenant drains 3 queries each
  time the pointer reaches it while everyone else still gets their turn —
  proportional share, not priority (a weight can slow nobody to zero).
- **Queue-depth caps** — ``DAFT_TPU_TENANT_QUEUE_CAP`` (global default,
  0 = unbounded) with per-tenant override ``DAFT_TPU_TENANT_QUEUE_CAP_<TENANT>``.
  A push past the cap raises :class:`TenantQueueFull` instead of queuing
  unboundedly; the gateway answers it with a typed ``over_capacity`` wire
  error so a flooding client backs off at the front door rather than
  inflating everyone's rotation latency.

Knobs are resolved once per tenant per queue (first push/pop that sees the
tenant) so the hot path never re-reads the environment.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from ..observability.metrics import registry
from ..utils.env import env_int


class TenantQueueFull(RuntimeError):
    """A tenant's queue is at its depth cap; the submit was refused (the
    caller should surface a typed over-capacity error, not retry blindly)."""

    def __init__(self, tenant: str, cap: int, depth: int):
        self.tenant = tenant
        self.cap = cap
        self.depth = depth
        super().__init__(
            f"tenant {tenant!r} admission queue at cap ({depth}/{cap}); "
            f"retry later or raise DAFT_TPU_TENANT_QUEUE_CAP")


def _tenant_env_suffix(tenant: str) -> str:
    """Tenant name -> env-var suffix: uppercased, every non-alphanumeric
    mapped to '_' (so tenant 'client-3' reads the `..._CLIENT_3` knobs)."""
    return "".join(c if c.isalnum() else "_" for c in tenant.upper())


def tenant_weight(tenant: str) -> int:
    """DAFT_TPU_TENANT_WEIGHT_<TENANT>: services per rotation visit (>= 1)."""
    return env_int(f"DAFT_TPU_TENANT_WEIGHT_{_tenant_env_suffix(tenant)}",
                   1, lo=1)


def tenant_queue_cap(tenant: str) -> int:
    """Per-tenant queue-depth cap: DAFT_TPU_TENANT_QUEUE_CAP_<TENANT>,
    falling back to the global DAFT_TPU_TENANT_QUEUE_CAP (0 = unbounded)."""
    default = env_int("DAFT_TPU_TENANT_QUEUE_CAP", 0, lo=0)
    return env_int(f"DAFT_TPU_TENANT_QUEUE_CAP_{_tenant_env_suffix(tenant)}",
                   default, lo=0)


class FairAdmissionQueue:
    """Thread-safe multi-tenant queue: ``push`` from any client thread,
    ``pop`` from the session's worker threads."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rotation: List[str] = []
        self._pos = 0
        self._size = 0
        # per-tenant QoS, resolved from the environment on first sight and
        # cached for the queue's lifetime (the hot path never re-reads env)
        self._weights: Dict[str, int] = {}
        self._caps: Dict[str, int] = {}
        # services the tenant AT the rotation pointer has left this visit
        # (weighted round-robin credit; reset whenever the pointer moves)
        self._credit = 0

    def _weight(self, tenant: str) -> int:
        w = self._weights.get(tenant)
        if w is None:
            w = self._weights[tenant] = tenant_weight(tenant)
        return w

    def _cap(self, tenant: str) -> int:
        c = self._caps.get(tenant)
        if c is None:
            c = self._caps[tenant] = tenant_queue_cap(tenant)
        return c

    def push(self, tenant: str, item: Any) -> int:
        """Enqueue one item for `tenant`; returns the new total depth.
        Raises :class:`TenantQueueFull` when the tenant is at its cap."""
        with self._cond:
            q = self._queues.get(tenant)
            cap = self._cap(tenant)
            if cap > 0 and q is not None and len(q) >= cap:
                registry().inc("serve_over_cap_rejections")
                raise TenantQueueFull(tenant, cap, len(q))
            if q is None:
                q = self._queues[tenant] = deque()
                self._rotation.append(tenant)
            q.append(item)
            self._size += 1
            self._cond.notify()
            return self._size

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Dequeue the next item in weighted per-tenant round-robin order
        (FIFO within the tenant), waiting up to `timeout` seconds; None on
        timeout. A tenant with weight W is served up to W consecutive items
        each time the rotation pointer reaches it."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._size > 0, timeout):
                return None
            n = len(self._rotation)
            for i in range(n):
                idx = (self._pos + i) % n
                tenant = self._rotation[idx]
                q = self._queues.get(tenant)
                if not q:
                    continue
                if i > 0:
                    # pointer moved past drained/absent tenants: fresh visit
                    self._credit = 0
                if self._credit <= 0:
                    self._credit = self._weight(tenant)
                item = q.popleft()
                self._size -= 1
                self._credit -= 1
                if not q:
                    # drained: leave the rotation; the pointer lands on the
                    # tenant that was NEXT (now shifted into this slot)
                    self._rotation.pop(idx)
                    del self._queues[tenant]
                    self._pos = idx % max(len(self._rotation), 1)
                    self._credit = 0
                elif self._credit > 0:
                    # weighted visit continues: stay on this tenant
                    self._pos = idx
                else:
                    self._pos = (idx + 1) % n
                return item
            return None  # unreachable while _size > 0

    def remove(self, tenant: str, item: Any) -> bool:
        """Remove one still-queued item (identity match) — the cancellation
        path: True only if the item was present, so exactly one of remove()
        and pop() ever owns a given ticket. Rotation fairness is preserved:
        removing a tenant's last item retires it from the rotation with the
        pointer re-aimed at whoever was next."""
        with self._cond:
            q = self._queues.get(tenant)
            if q is None:
                return False
            try:
                q.remove(item)
            except ValueError:
                return False
            self._size -= 1
            if not q:
                idx = self._rotation.index(tenant)
                self._rotation.pop(idx)
                del self._queues[tenant]
                if idx < self._pos:
                    self._pos -= 1
                elif idx == self._pos:
                    self._credit = 0
                self._pos = self._pos % max(len(self._rotation), 1)
            return True

    def depth(self, tenant: Optional[str] = None) -> int:
        with self._cond:
            if tenant is None:
                return self._size
            q = self._queues.get(tenant)
            return len(q) if q else 0

    def tenants(self) -> List[str]:
        with self._cond:
            return list(self._rotation)
