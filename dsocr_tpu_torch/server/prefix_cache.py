"""Prefix (prefill-packet) cache (dsocr_tpu/server/prefix_cache.py): reuse
a request's whole prefill result — vision-tower embeddings, prompt KV,
first-token logits — across requests with an identical (prompt, images,
vision) triple.

It works because a join never writes into its packet: SlotRunner.join
copies (or quantizes) the packet's row_k/row_v into the slot cache or
the page pool (runtime/slots.py, runtime/paged.py), so one packet can be
inserted into any number of rows, on any schedule.

Scope: exact-match full-prefix reuse (prompt text + raw image bytes +
VisionSettings), which covers re-OCR of the same page (retries,
multi-prompt extraction, deduplicated crawls). Partial-prefix reuse is
not attempted: vision embeddings land mid-prompt, so a text-only shared
prefix is a few tokens of KV.

Sampling stays per request: the packet stores pre-sampling prefill
logits, and the first token is selected with the request's own params
(the scheduler's wave selection, or the join's host selection), so a
cached packet is exact for greedy and re-sampled for stochastic requests.

Off by default: entries pin device memory (a DeepSeek 1024/640
crop-mode packet is [L, 1, H, 1024, D] K and V, ~63 MB in bf16 at full
width). Enable with DSOCR_PREFIX_CACHE=<max entries> or
ContinuousScheduler(prefix_cache=N).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, List, Optional

import numpy as np


def _digest_image(h, image: Any) -> None:
    arr = np.asarray(image)
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())


def request_key(prompt: str, images: List[Any], vision) -> str:
    """Digest of everything a prefill packet depends on: the prompt, the
    vision settings and every image's shape, dtype and bytes (blake2b)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(prompt.encode())
    h.update(repr(vision).encode())
    for image in images:
        _digest_image(h, image)
    return h.hexdigest()


class PrefixCache:
    """Small thread-safe LRU of prefill packets (engine.prefill_for_slot
    return dicts), with hit and miss counters."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            packet = self._entries.get(key)
            if packet is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return packet

    def record_alias_hit(self) -> None:
        """A wave-local duplicate was served by aliasing another job's
        prefill: reclassify the earlier get() miss as a hit, so that the
        hit rate counts the work saved."""
        with self._lock:
            self.misses -= 1
            self.hits += 1

    def put(self, key: str, packet: dict) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = packet
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
