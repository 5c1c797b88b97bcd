"""UTF-8-safe incremental streaming deltas (dsocr_tpu/core/streaming.py).

The tracker suppresses trailing U+FFFD replacement characters on
non-final updates so clients only ever receive complete UTF-8 sequences,
and lets the final flush through verbatim.
"""

from __future__ import annotations

REPLACEMENT_CHARACTER = "�"


def extract_delta(previous: str, current: str) -> str:
    """Suffix of `current` not covered by `previous` (common-prefix diff)."""
    if current.startswith(previous):
        return current[len(previous):]
    prefix = 0
    for a, b in zip(previous, current):
        if a != b:
            break
        prefix += 1
    return current[prefix:]


class DeltaTracker:
    """Tracks emitted text to compute new streaming deltas."""

    def __init__(self) -> None:
        self._previous = ""

    def reset(self) -> None:
        self._previous = ""

    def advance(self, current: str, is_final: bool = False) -> str:
        raw_delta = extract_delta(self._previous, current)

        if not raw_delta:
            self._previous = current
            return raw_delta

        if not is_final:
            idx = raw_delta.find(REPLACEMENT_CHARACTER)
            if idx == 0:
                return ""
            if idx > 0:
                raw_delta = raw_delta[:idx]
                self._previous += raw_delta
                return raw_delta

        self._previous = current
        return raw_delta

    @property
    def snapshot(self) -> str:
        return self._previous
