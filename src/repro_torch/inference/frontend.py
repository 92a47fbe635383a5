"""Request front-end plumbing for the serving engines.

* :class:`Request` — one submitted unit of work and its lifecycle
  (``queued -> running -> done``, or ``cancelled``).
* :class:`RequestHandle` — what ``submit()`` returns: an ``int`` (the
  request id, usable as the ``drain()`` dict key) with ``result()`` and
  ``cancel()``.
* :class:`RequestFrontEnd` — bucket validation, id/pending bookkeeping,
  the virtual-launch clock (``ticks``), the sliding per-request log and the
  latency summary with its queue-wait vs execution-time breakdown.

This slice serves CNN images; LM streaming, priorities, deadlines, fault
counters and MoE routing stats come back with the slices that use them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import activation_occupancy

QUEUED = "queued"        # submitted, waiting for drain()
RUNNING = "running"      # being drained
DONE = "done"            # result available
CANCELLED = "cancelled"  # withdrawn by cancel()


def validate_buckets(buckets: Sequence[int]) -> None:
    """Padding buckets must be non-empty, positive and ascending (a chunk
    pads up to the smallest bucket that fits, so order matters)."""
    if not buckets:
        raise ValueError("buckets must be a non-empty ascending tuple")
    if tuple(buckets) != tuple(sorted(buckets)) or \
            not all(b > 0 for b in buckets):
        raise ValueError(f"buckets must be positive ascending, "
                         f"got {tuple(buckets)}")


@dataclasses.dataclass
class Request:
    """One submitted request.  Wall-clock stamps feed ``latency_stats``;
    the ``*_tick`` twins come from the engine's virtual-launch clock."""

    id: int
    payload: Any
    state: str = QUEUED
    result: Optional[Any] = None
    submit_t: float = 0.0
    admit_t: float = 0.0
    finish_t: float = 0.0
    submit_tick: int = 0
    admit_tick: int = 0
    finish_tick: int = 0


class RequestHandle(int):
    """``submit()``'s return value: the request id plus the request API."""

    _req: Request
    _engine: "RequestFrontEnd"

    def __new__(cls, req: Request, engine: "RequestFrontEnd"):
        h = super().__new__(cls, req.id)
        h._req = req
        h._engine = engine
        return h

    @property
    def state(self) -> str:
        return self._req.state

    def result(self):
        """Drain if needed and return this request's output; raises if the
        request was cancelled."""
        return self._engine._result(self._req)

    def cancel(self) -> bool:
        """Withdraw the request; True if it was still queued."""
        return self._engine._cancel(self._req)


class RequestFrontEnd:
    """Mixin: request bookkeeping and latency accounting for the engines."""

    _next_id: int
    _pending: List[Request]
    _request_log: Deque[Dict[str, Any]]
    ticks: int

    def _init_front_end(self, stats_window: int) -> None:
        self._next_id = 0
        self._pending = []
        self._request_log = collections.deque(maxlen=stats_window)
        # virtual-launch clock: +1 per forward launch (deterministic)
        self.ticks = 0
        # the skip counters are process-wide: report this engine's delta
        self._skip_stats_base = activation_occupancy.skip_stats()

    def _new_request(self, payload: Any) -> RequestHandle:
        req = Request(id=self._next_id, payload=payload,
                      submit_t=time.perf_counter(), submit_tick=self.ticks)
        self._next_id += 1
        self._pending.append(req)
        return RequestHandle(req, self)

    def _log_request(self, **entry: Any) -> None:
        self._request_log.append(entry)

    def drain(self) -> Dict[int, Any]:
        raise NotImplementedError

    def _result(self, req: Request):
        if req.state in (QUEUED, RUNNING):
            self.drain()
        if req.state == CANCELLED:
            raise RuntimeError(f"request {req.id} was cancelled")
        return req.result

    def _cancel(self, req: Request) -> bool:
        if req.state != QUEUED:
            return False
        req.state = CANCELLED
        self._pending = [r for r in self._pending if r.id != req.id]
        return True

    def latency_stats(self) -> Dict[str, float]:
        """Latency over the last ``stats_window`` served requests: total
        (mean/p50/p95/max), queue wait (submit -> start of its batch) and
        execution (batch start -> done) at p50/p95, and mean batch fill."""
        lat = np.array([r["latency_ms"] for r in self._request_log])
        if lat.size == 0:
            return {"requests": 0, **self._skip_stats_delta()}
        out = {
            "requests": int(lat.size),
            "mean_ms": float(lat.mean()),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
            "mean_batch_fill": float(np.mean(
                [r["batch_fill"] for r in self._request_log])),
        }
        for key, label in (("queue_wait_ms", "queue_wait"),
                           ("decode_ms", "decode")):
            vals = np.array([r[key] for r in self._request_log])
            out[f"{label}_p50_ms"] = float(np.percentile(vals, 50))
            out[f"{label}_p95_ms"] = float(np.percentile(vals, 95))
        out.update(self._skip_stats_delta())
        return out

    def _skip_stats_delta(self) -> Dict[str, float]:
        """This engine's activation-skip traffic since construction; empty
        when no masked launch ran."""
        cur = activation_occupancy.skip_stats()
        weight = (cur["weight_tile_dots"]
                  - self._skip_stats_base["weight_tile_dots"])
        if weight <= 0:
            return {}
        executed = (cur["executed_tile_dots"]
                    - self._skip_stats_base["executed_tile_dots"])
        return {"executed_tile_dots": int(executed),
                "weight_tile_dots": int(weight),
                "act_skip_frac": float(1.0 - executed / weight)}
