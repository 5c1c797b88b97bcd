"""Request-level types of the serving path: vision settings, decode
parameters and the decode outcome (field-for-field the reference's
dsocr_tpu/core/params.py and core/engine.py types, so either package's
objects can drive the other's scheduler)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class VisionSettings:
    base_size: int
    image_size: int
    crop_mode: bool


@dataclasses.dataclass
class DecodeParameters:
    """Defaults: 512 new tokens, greedy, no-repeat-ngram 20."""

    max_new_tokens: int = 512
    do_sample: bool = False
    temperature: float = 0.0
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = None
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: Optional[int] = 20
    seed: Optional[int] = None
    use_cache: bool = True


@dataclasses.dataclass
class DecodeOutcome:
    text: str
    prompt_tokens: int
    response_tokens: int
    generated_tokens: List[int]
    # True when max_new_tokens was cut to fit the KV-cache budget
    truncated: bool = False


def normalize_text(s: str) -> str:
    """Strip the end-of-sentence sentinel and CRLF line endings."""
    return s.replace("\r\n", "\n").replace("<｜end▁of▁sentence｜>", "").strip()
