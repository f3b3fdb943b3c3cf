"""ISO-8601 ↔ float epoch-days conversion at the host boundary.

Device tensors carry timestamps as float64-representable *days since the
Unix epoch* so elapsed time is a single subtract on device. The sentinel
0.0 means "never updated" (cold start), mirroring the empty-string
``updated_at`` sentinel of the record layer; invalid timestamps also map to
the sentinel, matching scalar parsing semantics (reference: decay.py:126-131).
"""

from __future__ import annotations

from datetime import datetime, timezone

SECONDS_PER_DAY = 86400.0

#: Device-side sentinel for "never updated".
NEVER = 0.0


def iso_to_days(timestamp: str | None) -> float:
    """ISO timestamp → epoch-days; ``NEVER`` for empty/None/invalid."""
    if not timestamp:
        return NEVER
    try:
        stamp = datetime.fromisoformat(timestamp)
    except ValueError:
        return NEVER
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=timezone.utc)
    return stamp.timestamp() / SECONDS_PER_DAY


def days_to_iso(epoch_days: float) -> str:
    """Epoch-days → ISO timestamp; empty string for the ``NEVER`` sentinel."""
    if epoch_days <= NEVER:
        return ""
    return datetime.fromtimestamp(
        epoch_days * SECONDS_PER_DAY, tz=timezone.utc
    ).isoformat()


def now_days() -> float:
    """Current UTC time in epoch-days."""
    return datetime.now(timezone.utc).timestamp() / SECONDS_PER_DAY


def utc_now_iso() -> str:
    """Timestamp format stored in ``updated_at`` (reference: reliability.py:175).

    Lives here — not in ``state.update_math`` — because the pure-math
    modules are clock-free by contract (lint rule DT202); this module owns
    the host clock.
    """
    return datetime.now(timezone.utc).isoformat()
