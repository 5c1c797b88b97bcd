"""OpenAI chat messages → (prompt, images) (dsocr_tpu/server/messages.py).

History collapses to the system messages before the latest user turn and
that turn (OCR models are not chat-trained); a message's parts are
flattened in reverse order (images first); images come only from data:
URLs or http(s) fetches (urllib, 30 s timeout) and are decoded by
image/decode.py (PNG and JPEG, natively and bit-equal to the reference's
Pillow): a format or JPEG variant it does not read, or bytes that do not
decode, is a 400 naming what is wrong.
"""

from __future__ import annotations

import base64
import binascii
import urllib.request
from typing import Any, List, Mapping, Sequence, Tuple

import numpy as np

from ..image.decode import ImageDecodeError, decode_image

FETCH_TIMEOUT_S = 30


class ApiError(Exception):
    def __init__(self, message: str, status: int = 400, kind: str = "invalid_request_error"):
        super().__init__(message)
        self.message = message
        self.status = status
        self.kind = kind

    def body(self) -> dict:
        return {"error": {"message": self.message, "type": self.kind}}


def prompt_missing_image(prompt: str) -> bool:
    return "<image>" not in prompt


MISSING_IMAGE_MARKDOWN = (
    "⚠️ **Image Required**\n\n- This OCR backend expects at least one "
    "`<image>` placeholder or attached image.\n- Please include "
    "`input_image` / `image_url`, or add `<image>` inside the prompt.\n\n"
    "---\n\n⚠️ **需要图像输入**\n\n- 当前 OCR 模型需要至少一个 `<image>` "
    "占位符或实际图片。\n- 请在请求中附带 `input_image`/`image_url`，"
    "或在 prompt 中插入 `<image>`。"
)


def _decode(raw: bytes, where: str) -> np.ndarray:
    try:
        return decode_image(raw)
    except ImageDecodeError as err:
        raise ApiError(f"failed to decode {where} image: {err}")


def load_image(url: str) -> np.ndarray:
    if url.startswith("data:"):
        rest = url[len("data:"):]
        if "," not in rest:
            raise ApiError("invalid data URL")
        meta, payload = rest.split(",", 1)
        if not meta.endswith(";base64"):
            raise ApiError("data URLs must specify base64 encoding")
        try:
            raw = base64.b64decode(payload, validate=False)
        except (binascii.Error, ValueError) as err:
            raise ApiError(f"invalid base64 image payload: {err}")
        return _decode(raw, "inline")
    if url.startswith("http://") or url.startswith("https://"):
        try:
            with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
                raw = resp.read()
        except Exception as err:
            raise ApiError(f"failed to fetch {url}: {err}")
        return _decode(raw, "remote")
    raise ApiError("only data: URIs or http(s) image URLs are supported")


def _image_url_of(part: Mapping[str, Any]) -> str:
    payload = part.get("image_url")
    if isinstance(payload, str):
        return payload
    if isinstance(payload, Mapping):
        return payload.get("url", "")
    return ""


def _flatten_content(content: Any) -> Tuple[str, List[np.ndarray]]:
    if content is None:
        return "", []
    if isinstance(content, str):
        return content.strip(), []
    buffer = ""
    images: List[np.ndarray] = []
    for part in reversed(list(content)):  # the reference's part order, reversed
        ptype = part.get("type", "")
        if ptype in ("image_url", "input_image"):
            buffer += "<image>"
            images.append(load_image(_image_url_of(part)))
        elif ptype in ("text", "input_text"):
            if buffer:
                buffer += "\n"
            buffer += part.get("text", "")
    return buffer.strip(), images


def convert_messages(messages: Sequence[Mapping[str, Any]]) -> Tuple[str, List[np.ndarray]]:
    """System messages before the latest user turn, then that turn, joined
    with blank lines → (prompt, images)."""
    latest_user = None
    for idx in range(len(messages) - 1, -1, -1):
        if str(messages[idx].get("role", "")).lower() == "user":
            latest_user = idx
            break
    if latest_user is None:
        raise ApiError("request must include at least one user message")

    sections: List[str] = []
    images: List[np.ndarray] = []
    for message in messages[:latest_user]:
        if str(message.get("role", "")).lower() != "system":
            continue
        text, msg_images = _flatten_content(message.get("content"))
        if text:
            sections.append(text)
        images.extend(msg_images)
    user_text, user_images = _flatten_content(messages[latest_user].get("content"))
    if user_text:
        sections.append(user_text)
    images.extend(user_images)
    if not sections and not images:
        raise ApiError("user content must include text or images")
    return "\n\n".join(sections).strip(), images
