"""Which seeds and requests the smoke's mesh cases can use: greedy tokens of
random full-width weights sit on near-ties that a mesh's different
summation order could flip, so a case's seed must keep every
single-process top-2 margin above chip_smoke.MESH_LOGIT_TOL.

    python3 mesh_seeds.py seeds [case ...] [--seeds 0-8]
    python3 mesh_seeds.py requests

``seeds``: for each chip_smoke.MESH_DENSE case named (all by default),
the case's single-process burst (chip_smoke.mesh_reference on
chip_smoke.dense_engine at each weight seed): one JSON line a seed with
its least margin and step; a case stops after two clear seeds.
``requests``: the (h) server request's candidate texts and token counts
on the seeded bf16 DotsOCR engine (what the front ends' files hold) with
the front ends' synthetic tokenizer, page and vision: the margin of every
decode step.

Runs on a machine with a CUDA card; prints the card's name and power
limit first.
"""

import argparse
import asyncio
import gc
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# the (h) candidates: (text after the image, new tokens)
REQUESTS = (("Free OCR.", 64), ("OCR this page.", 32), ("Read the text.", 32),
            ("Convert the document to markdown.", 32), ("Parse the layout.", 32))


def seeds(torch, cs, cases, seed_range):
    for case, family, _, quantize, _ in cs.MESH_DENSE:
        if cases and case not in cases:
            continue
        clear = 0
        for seed in seed_range:
            engine = cs.dense_engine(torch, family, quantize, seed=seed)
            try:
                cs.mesh_reference(torch, engine, case, *cs.MESH_DENSE_BURST, page=cs.dense_case_page(engine, family))
                ok = True
            except RuntimeError:  # mesh_reference's near-tie check
                ok = False
            least, step = cs.mesh_seed_margin(cs.MESH_REFS[case]["margins"])
            cs.emit({"phase": "seed", "case": case, "family": family, "seed": seed, "clear": ok, "least": least,
                     "step": step})
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            clear += ok
            if clear == 2:
                break


def requests(torch, cs):
    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.core.text import render_prompt
    from dsocr_tpu_torch.image.decode import decode_image
    from dsocr_tpu_torch.models.dots import DotsConfig, DotsOcrEngine
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler
    from dsocr_tpu_torch.utils.tokenizer import load_tokenizer

    cfg = DotsConfig()
    engine = DotsOcrEngine(cfg, dtype=torch.bfloat16, device="cuda", max_seq_len=cs.GLM_SLOT_SEQ, seed=0)
    cs.round_tower_(torch, engine)
    directory = os.path.join(HERE, "dsocr_tpu_torch", "_build", "mesh_seeds")
    os.makedirs(directory, exist_ok=True)
    tok = load_tokenizer(cs.synthetic_tokenizer(os.path.join(directory, "tokenizer.json"), cfg.text.vocab_size,
                                                cs.DOTS_SPECIALS))
    decoded = decode_image(cs.png_bytes(cs.seeded_page()[0]))
    margins, step = [], engine.slot_step_fn

    def spy(decoder, token_ids, cache, pos):
        logits = step(decoder, token_ids, cache, pos)
        margins.append(cs.top2_margin(torch, logits)[int(cache.lengths.argmax())])
        return logits

    engine.slot_step_fn = spy
    for text, max_new in REQUESTS:
        margins.clear()
        out = asyncio.run(ContinuousScheduler(engine, tok, max_len=cs.FRONTEND_SLOT_SEQ).submit(
            render_prompt("plain", "", "<image>\n" + text), [decoded], VisionSettings(1024, 640, False),
            DecodeParameters(max_new_tokens=max_new)))
        least, at = cs.mesh_seed_margin(margins)
        cs.emit({"phase": "request", "text": text, "max_new": max_new, "tokens": len(out.generated_tokens),
                 "least": least, "at": at, "below_tol": [i for i, m in enumerate(margins) if m <= cs.MESH_LOGIT_TOL]})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("scan", choices=("seeds", "requests"))
    parser.add_argument("cases", nargs="*", help="MESH_DENSE case letters (seeds; default all)")
    parser.add_argument("--seeds", default="0-8", help="weight seeds to try, a range a-b")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_seeds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops.kernels import _lib

    set_f32_precision()
    print(cs.smi_line(), flush=True)
    _lib.lib()
    if args.scan == "seeds":
        lo, _, hi = args.seeds.partition("-")
        seeds(torch, cs, set(args.cases), range(int(lo), int(hi or lo) + 1))
    else:
        requests(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
