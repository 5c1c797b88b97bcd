"""The inference CLI (dsocr_tpu/cli/app.py):

    python -m dsocr_tpu_torch.cli --model deepseek-ocr --prompt "<image>\\nFree OCR." --image page.png

config.toml and the flags' overrides → the model's files (local only:
config/resolver.py) → load_engine on the card (``--device cpu`` for the
host) → the prompt through the conversation template → the image count
checked against the ``<image>`` slots → PNG or JPEG pages decoded by
image/decode.py → ``engine.decode`` with the deltas streamed to stdout
(UTF-8 safe) → a throughput line on stderr, ``--output-json`` (the result) and
``--bench-output`` (the stage timings of core/benchmark.py). ``--quiet``
keeps stdout to the text. ``weights snapshot`` prints the port's
``dsq export`` command for a model's checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
from typing import List, Optional

from ..config import AppConfig, VirtualFileSystem, prepare_model_paths
from ..config.args import add_common_inference_args, add_common_model_args, inference_override_from_args
from ..core.benchmark import BenchRecorder, Timer, set_recorder
from ..core.params import VisionSettings
from ..core.streaming import DeltaTracker
from ..core.text import render_prompt


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dsocr-torch", description="OCR inference CLI (PyTorch port)")
    sub = parser.add_subparsers(dest="subcommand")

    run = parser  # the flags live on the root parser, as the reference's do
    run.add_argument("--prompt", default=None, help="prompt text (use <image> slots)")
    run.add_argument("--prompt-file", default=None, help="read the prompt from a file")
    run.add_argument("--image", action="append", default=[], help="image path (repeatable)")
    add_common_model_args(run)
    add_common_inference_args(run)
    run.add_argument("--bench", action="store_true", help="record stage timings")
    run.add_argument("--bench-output", default=None, help="write bench JSON here")
    run.add_argument("--output-json", default=None, help="write decode result JSON")
    run.add_argument("--quiet", action="store_true", help="suppress logs; stdout = text")
    run.add_argument("--max-seq-len", type=int, default=8192)

    weights = sub.add_parser("weights", help="weight utilities")
    wsub = weights.add_subparsers(dest="weights_command", required=True)
    snap = wsub.add_parser("snapshot", help="print the dsq export command")
    snap.add_argument("--model", default=None)
    snap.add_argument("--dtype", default="q6k")
    return parser


def run_weights_snapshot(args) -> int:
    model_id = args.model or "deepseek-ocr"
    vfs = VirtualFileSystem()
    print("python -m dsocr_tpu_torch.dsq export "
          f"--weights {vfs.model_weights(model_id)} "
          f"--config {vfs.model_config(model_id)} "
          f"--dtype {args.dtype} --targets text "
          f"--output {vfs.model_snapshot(model_id + '-' + args.dtype)}")
    return 0


def run_inference(args) -> int:
    from ..core.runtime_device import apply_device_selection
    from ..image.decode import decode_image
    from ..models.registry import load_engine
    from ..utils.logging import init_logging
    from ..utils.tokenizer import load_tokenizer

    quiet = args.quiet
    init_logging(quiet=quiet)
    recorder: Optional[BenchRecorder] = None
    if args.bench or args.bench_output:
        recorder = BenchRecorder()
        set_recorder(recorder)

    def log(*parts):
        if not quiet:
            print(*parts, file=sys.stderr)

    prompt = args.prompt
    if args.prompt_file:
        prompt = pathlib.Path(args.prompt_file).read_text()
    if prompt is None:
        print("error: --prompt or --prompt-file required", file=sys.stderr)
        return 1

    config_path = pathlib.Path(args.config) if args.config else VirtualFileSystem().config_file()
    config = AppConfig.load_or_init(config_path)
    model_id = args.model or config.models.active
    entry = config.models.entries.get(model_id)
    if entry is None:
        print(f"error: unknown model `{model_id}`", file=sys.stderr)
        return 1
    settings = config.resolved_inference(model_id, inference_override_from_args(args))

    slots = prompt.count("<image>")  # image slots must match the images given
    if slots != len(args.image):
        print(f"error: prompt has {slots} <image> slots but {len(args.image)} images were provided",
              file=sys.stderr)
        return 1

    if args.model_config or args.tokenizer or args.weights:
        def given(value):
            return pathlib.Path(value) if value else None

        model_config, tokenizer_path = given(args.model_config), given(args.tokenizer)
        weights_path, snapshot_path = given(args.weights), given(args.snapshot)
    else:
        log(f"Resolving files for {model_id}...")
        paths = prepare_model_paths(config, model_id)
        model_config, tokenizer_path = paths.config, paths.tokenizer
        weights_path, snapshot_path = paths.weights, paths.snapshot
    if tokenizer_path is None:
        print("error: tokenizer path unresolved", file=sys.stderr)
        return 1

    device = apply_device_selection(settings.device)
    load_timer = Timer("model.load")
    engine = load_engine(entry.kind, config_path=model_config, weights_path=weights_path,
                         snapshot_path=snapshot_path, dtype=settings.precision, max_seq_len=args.max_seq_len,
                         mesh=args.mesh, kv_quant=args.kv_quant or os.environ.get("DSOCR_KV_QUANT") or None,
                         device=device)
    load_timer.finish(model=model_id)
    tokenizer = load_tokenizer(tokenizer_path)

    images = [decode_image(pathlib.Path(p).read_bytes()) for p in args.image]
    rendered = render_prompt(settings.template, "", prompt)
    vision = VisionSettings(base_size=settings.base_size, image_size=settings.image_size,
                            crop_mode=settings.crop_mode)
    tracker = DeltaTracker()

    def stream(step: int, tokens: List[int]) -> None:
        delta = tracker.advance(tokenizer.decode(tokens, skip_special_tokens=True))
        if delta:
            print(delta, end="", flush=True)

    t0 = time.perf_counter()
    outcome = engine.decode(tokenizer, rendered, images, vision, settings.decode,
                            stream=None if args.output_json else stream)
    wall = time.perf_counter() - t0
    if not args.output_json:
        final_delta = tracker.advance(outcome.text, is_final=True)
        if final_delta:
            print(final_delta, end="")
        print(flush=True)

    tok_s = outcome.response_tokens / wall if wall > 0 else 0.0
    log(f"prompt_tokens={outcome.prompt_tokens} response_tokens={outcome.response_tokens} "
        f"wall={wall:.2f}s decode={tok_s:.1f} tok/s")

    if args.output_json:
        result = {"text": outcome.text, "prompt_tokens": outcome.prompt_tokens,
                  "response_tokens": outcome.response_tokens, "generated_tokens": outcome.generated_tokens,
                  "rendered_prompt": rendered}
        pathlib.Path(args.output_json).write_text(json.dumps(result, indent=2))

    if recorder is not None:
        report = recorder.to_json()
        if args.bench_output:
            pathlib.Path(args.bench_output).write_text(json.dumps(report, indent=2))
        else:
            log(json.dumps(report["stage_totals"], indent=2))
        set_recorder(None)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.subcommand == "weights":
        return run_weights_snapshot(args) if args.weights_command == "snapshot" else 1
    return run_inference(args)
