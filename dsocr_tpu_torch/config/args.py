"""The argparse groups that the CLI and the server share
(dsocr_tpu/config/args.py): the same flags, so a command line means the
same to both packages. ``--device`` takes cuda or cpu here (None: the
config's, which defaults to cuda); ``--mesh dp=N,mp=M[,ep]`` serves any
family over dp × mp rank processes (load_engine), this process rank 0."""

from __future__ import annotations

import argparse

from ..core.params import DecodeParametersPatch
from .app import InferenceOverride


def add_common_model_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("model")
    group.add_argument("--model", default=None, help="model id from the registry")
    group.add_argument("--config", default=None, help="app config.toml path")
    group.add_argument("--model-config", default=None, help="model config.json path")
    group.add_argument("--tokenizer", default=None, help="tokenizer.json path")
    group.add_argument("--weights", default=None, help="safetensors weights path")
    group.add_argument("--snapshot", default=None, help="DSQ snapshot path")
    group.add_argument("--mesh", default=None,
                       help="mesh spec for sharded execution over rank processes, e.g. dp=1,mp=2 "
                            "(add ,ep for expert parallelism: DeepSeek-OCR's experts; the other "
                            "families ignore it)")
    group.add_argument("--kv-quant", default=None, choices=("int8",),
                       help="quantize the serving KV cache (slot runtime): int8 codes + per-token scales")


def add_common_inference_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("inference")
    group.add_argument("--device", default=None, help="cuda | cpu")
    group.add_argument("--dtype", default=None, help="bfloat16 | float32")
    group.add_argument("--template", default=None, help="conversation template")
    group.add_argument("--base-size", type=int, default=None)
    group.add_argument("--image-size", type=int, default=None)
    group.add_argument("--crop-mode", default=None, type=lambda v: v.lower() in ("1", "true", "yes", "on"),
                       help="true/false")
    group.add_argument("--max-new-tokens", type=int, default=None)
    group.add_argument("--no-cache", action="store_true", default=False)
    group.add_argument("--do-sample", action="store_true", default=None)
    group.add_argument("--temperature", type=float, default=None)
    group.add_argument("--top-p", type=float, default=None)
    group.add_argument("--top-k", type=int, default=None)
    group.add_argument("--repetition-penalty", type=float, default=None)
    group.add_argument("--no-repeat-ngram-size", type=int, default=None)
    group.add_argument("--seed", type=int, default=None)


def add_server_bind_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("server")
    group.add_argument("--host", default=None)
    group.add_argument("--port", type=int, default=None)
    group.add_argument("--prefix-cache", type=int, default=None, metavar="N",
                       help="cache the last N prefill packets and reuse them for byte-identical "
                            "(prompt, images) requests (DSOCR_PREFIX_CACHE env is the fallback)")


def inference_override_from_args(args: argparse.Namespace) -> InferenceOverride:
    decode = DecodeParametersPatch(
        max_new_tokens=args.max_new_tokens, do_sample=args.do_sample, temperature=args.temperature,
        top_p=args.top_p, top_k=args.top_k, repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size, seed=args.seed,
        use_cache=False if args.no_cache else None,
    )
    return InferenceOverride(device=args.device, precision=args.dtype, template=args.template,
                             base_size=args.base_size, image_size=args.image_size, crop_mode=args.crop_mode,
                             decode=decode)
