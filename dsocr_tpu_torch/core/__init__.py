"""Core pieces of the port: device selection, request types and token
sampling."""

from .params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text

__all__ = ["DecodeOutcome", "DecodeParameters", "VisionSettings", "normalize_text"]
