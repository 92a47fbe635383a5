"""Runtime activation-side occupancy — the two-sided skip.

The kneaded schedule is static (weight side).  A work item whose activation
K-slice is all zero adds exactly 0 whatever plane it names, so in the
decode-GEMV regime per-K-tile activation presence is intersected with the
schedule into a per-slot survival mask, which the SAC kernel walks in place
of the counts.  Dropped items would add +0.0 to their f32 segment, and
survivors keep their k-major order, so skip-on equals skip-off bit for bit.

Accounting is plain Python counters (executed vs weight-only tile dots),
snapshotted by each engine, which reports its own delta.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

__all__ = ["GEMV_ROWS_MAX", "ktile_presence", "weight_only_mask",
           "work_mask", "record_skip", "skip_stats", "reset_skip_stats"]

# The decode-GEMV gate: activation skip engages only when the flattened
# activation has at most this many rows.  Over hundreds of rows the union
# of presence is all ones, so masking would cost time and skip nothing.
GEMV_ROWS_MAX = 8


def ktile_presence(a: torch.Tensor, ks: int) -> torch.Tensor:
    """int32 [K // ks]: 1 where any row of ``a`` is nonzero in the K-tile.
    ``a`` is already padded to the stored K."""
    m, k = a.shape
    if k % ks:
        raise ValueError(f"activation K {k} not divisible by ks={ks}")
    return (a.reshape(m, k // ks, ks) != 0).any(dim=2).any(dim=0).to(
        torch.int32)


def weight_only_mask(counts: torch.Tensor, num_work: int) -> torch.Tensor:
    """int32 [n_tiles, num_work]: 1 for real items (``w < counts[j]``), 0
    for the padding tail — the static schedule's own walk."""
    w = torch.arange(num_work, dtype=torch.int32, device=counts.device)
    return (w[None, :] < counts[:, None]).to(torch.int32)


def work_mask(counts: torch.Tensor, ktile_ids: torch.Tensor,
              act_presence: Optional[torch.Tensor]) -> torch.Tensor:
    """Survival mask over schedule slots: real items whose activation
    K-tile is present.  ``act_presence=None`` is the weight-only mask."""
    base = weight_only_mask(counts, ktile_ids.shape[-1])
    if act_presence is None:
        return base
    alive = (act_presence[ktile_ids.long()] != 0).to(torch.int32)
    return base * alive


# ---------------------------------------------------------------------------
# Skip accounting — executed vs weight-only tile dots, per process
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_EXECUTED = 0
_WEIGHT_ONLY = 0
_CALLS = 0


def record_skip(mask: torch.Tensor, counts: torch.Tensor) -> None:
    """Fold one masked launch into the counters (reads the sums back)."""
    global _EXECUTED, _WEIGHT_ONLY, _CALLS
    executed, weight_only = int(mask.sum()), int(counts.sum())
    with _LOCK:
        _EXECUTED += executed
        _WEIGHT_ONLY += weight_only
        _CALLS += 1


def skip_stats() -> Dict[str, float]:
    """``executed_tile_dots``, ``weight_tile_dots``, ``skip_calls`` and
    ``act_skip_frac = 1 - executed / weight_only`` (0.0 when empty)."""
    with _LOCK:
        executed, weight_only, calls = _EXECUTED, _WEIGHT_ONLY, _CALLS
    frac = 1.0 - executed / weight_only if weight_only else 0.0
    return {"executed_tile_dots": executed, "weight_tile_dots": weight_only,
            "skip_calls": calls, "act_skip_frac": frac}


def reset_skip_stats() -> None:
    """Zero the counters (test isolation)."""
    global _EXECUTED, _WEIGHT_ONLY, _CALLS
    with _LOCK:
        _EXECUTED = _WEIGHT_ONLY = _CALLS = 0
