"""Stage timers and bench event recording (dsocr_tpu/core/benchmark.py).

Named stage timers record ``BenchEvent{stage, duration, fields}`` into a
process-global recorder slot; when no recorder is installed, timers are
no-ops. The JSON dump schema is ``{"events": [...], "stage_totals":
{...}}``, the reference's.

Stage names, the reference's strings:
    model.load, prompt.render, prompt.build_tokens,
    vision.prepare_inputs, vision.compute_embeddings,
    decode.prefill, decode.iterative, decode.generate;
    serving: slot.prepare_inputs, slot.vision_towers, slot.prefill_rows
    (models/deepseek/engine.py), slot.join, slot.decode_chunk,
    slot.harvest, slot.release, slot.prefix_hit (server/scheduler.py).

A timer reads the host clock. The port's device work is asynchronous, so
a stage that ends in device work is timed to its end only where the code
synchronizes inside it (the engine does so while a recorder is
installed).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class BenchEvent:
    stage: str
    duration_ms: float
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "stage": self.stage,
            "duration_ms": self.duration_ms,
            "fields": self.fields,
        }


class BenchRecorder:
    """Thread-safe event sink with stage aggregation."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[BenchEvent] = []

    def record(self, event: BenchEvent) -> None:
        with self._lock:
            self._events.append(event)

    def record_instant(self, stage: str, **fields: Any) -> None:
        self.record(BenchEvent(stage=stage, duration_ms=0.0, fields=fields))

    @property
    def events(self) -> List[BenchEvent]:
        with self._lock:
            return list(self._events)

    def stage_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for event in self.events:
            totals[event.stage] = totals.get(event.stage, 0.0) + event.duration_ms
        return totals

    def to_json(self) -> Dict[str, Any]:
        return {
            "events": [e.to_json() for e in self.events],
            "stage_totals": self.stage_totals(),
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)


_RECORDER_LOCK = threading.Lock()
_RECORDER: Optional[BenchRecorder] = None


def set_recorder(recorder: Optional[BenchRecorder]) -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = recorder


def get_recorder() -> Optional[BenchRecorder]:
    return _RECORDER


def record_instant(stage: str, **fields: Any) -> None:
    recorder = get_recorder()
    if recorder is not None:
        recorder.record_instant(stage, **fields)


class Timer:
    """Stage timer; a no-op when no global recorder is installed."""

    def __init__(self, stage: str):
        self.stage = stage
        self._start = time.perf_counter() if get_recorder() is not None else None

    def finish(self, **fields: Any) -> float:
        if self._start is None:
            return 0.0
        duration_ms = (time.perf_counter() - self._start) * 1000.0
        recorder = get_recorder()
        if recorder is not None:
            recorder.record(
                BenchEvent(stage=self.stage, duration_ms=duration_ms, fields=fields)
            )
        return duration_ms

    def __enter__(self) -> "Timer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.finish()
