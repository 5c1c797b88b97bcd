#!/usr/bin/env python3
"""Drive the PyTorch port (dsocr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (nothing is caught):

1. env      torch/CUDA versions and the card's name and power limit;
2. build    nvcc of dsocr_tpu_torch/csrc/*.cu into one shared library;
3. kernels  each hand-written kernel against its plain PyTorch twin at
            the main path's shapes: max abs error against the stated
            tolerance, kernel, plain and library device milliseconds per
            call (CUDA events around 10 calls queued behind a GPU sleep,
            median of 3; the library call is one PyTorch call computing the
            same function, timed here and used nowhere in the port), and
            the bound: the larger of the bytes the call must move over
            3.35 TB/s and its operations over the peak rate of their type;
            sam_flash_attention at one page's views (BH 12 at S 4096, BH 72
            at S 1600), at the engine's launches (BH 48, BH 192) and at
            the 1280 view's 80 × 80 grid (S 6400, BH 12 and 48) and a
            128 × 128 grid past the staged bias's shared-memory budget (BH
            2), two launches bit-equal, bound 3xTF32 on the tensor cores
            with the f32 FMA bound beside it;
            flash_prefill_attention also at the profile's wave (B 16, S
            1024, no pads) and with pads at the tile boundaries 63/64/65,
            slot_decode_attention also at the serving step (16 rows of
            904-1031 positions in a 1536-position cache) and with rows
            ending on either side of a split boundary, bf16 and int8; two
            launches of either attention, and of the paged attend, must
            give the same bits;
            the dense expert sweeps of the three formats (gate+up and down
            of one MoE layer at N 16) and their gather tier at
            GATHER_DRAWS (6, 24 and 60 routed selections, 24 and 60 that
            share one top-6; bound: the distinct experts' bytes), two
            launches bit-equal;
            q8_matmul, q4k_matmul and q6k_matmul at ROW_CASES (the lm_head
            at N 16; qkv at N 1, 16, 1024 and 16384: the decode GEMV and
            the dequant pass + wgmma GEMM; shared down at N 16), two
            launches bit-equal, library time torch.matmul on the bf16
            weights dequantized outside the timing;
            the Q8_0 quantizer on the card bit for bit against its CPU run
            on a full-width expert stack, and the Q4_K and Q6_K quantizers
            on KQUANT_CHECK_EXPERTS (4) experts of one; the paged KV write and attend (16 rows of
            ~968 tokens in 9 pages of 128 each, int8 and bf16 pools; the
            library time of the attend is SDPA over the rows' pages gathered
            outside the timing); the KV writes from the decoder's token,
            slot_kv_write and paged_kv_write (int8 and bf16 caches, bf16
            and f32 tokens with an all-zero row and rounding ties from
            kv_tokens, every plane torch.equal to the twin's, beside them
            route_ms: quantize_kv_int8 and the codes-in write, as the step
            wrote before); the megafused Q8_0 chain (one MoE layer at 16,
            11 and 32 rows, tolerance megafused_tol per element, two
            launches bit-equal, beside it the two-kernel sweep it replaces,
            sweep_ms) and
            gather_matmul (the split layout's expert gather, gate/up and
            down stacks at 96, 12 and 1 rows, and 96 rows on 4 experts,
            bf16 and f32, two launches bit-equal; library time
            index_select + bmm; each timed hot, the same stack call after
            call, and cold, rotating among copies of the stack);
            the new families' grouped heads (check_grouped_heads,
            GROUPED_HEADS, D 128, bf16): PaddleOCR-VL's 16 query heads over
            2, DotsOCR's 12 over 2 and GLM-OCR's 16 over 8;
            flash_prefill_attention at a page's 3,700-token prompt (and for
            Dots and GLM at 6,200), B 1 and B 4 with left pads 0/300/7/1000
            (library time SDPA with enable_gqa), and slot_kv_write and
            slot_decode_attention on each family's cache (L 18, 28 and 24,
            B 16, S_max 4096, 4096 and 8192, bf16 and int8, lengths 0 and
            S − 1 among them), two launches bit-equal; the same at a
            mesh rank's heads (MESH_GROUPED_HEADS: 8 over 1, 6 over 1, 8
            over 4; a 4-row wave, 4 slots); the three row
            formats at DotsOCR's packed shapes (check_rows,
            DOTS_ROW_CASES: qkv 1536 → 2048, gate/up 1536 → 17920, down
            8960 → 1536 with an odd count of K-quant super-blocks, the
            untied lm_head 1536 → 151936, at N 1, 16 and 1024) and
            q8_matmul at PaddleOCR-VL's four (PADDLE_ROW_CASES: 1024 →
            2560, 2048 → 1024, 1024 → 6144, 3072 → 1024 at N 2 and 4, a
            dp rank's rows and the whole step's);
    host_prep  host image prep of the seeded page (below) on the card's
            host: engine.prepare_vision_input with the native resampler and
            with its NumPy twin, the global view and every tile bit-equal,
            and seeded images at a few sizes resized both ways bit-equal;
            seconds a page of each (median of 3), a 16-page prep wave
            through the engine's prefill (its thread pool), os.cpu_count();
            then (host_prep_jpeg) the two JPEG page fixtures decoded on
            the host, median ms of 3, their digests equal to Pillow's, and
            the PNG of the baseline's pixels decoded, beside the card;
            (host_prep_formats) the same for the G4 and LZW TIFF, BMP and
            GIF page fixtures (tests/data/format_pages.json);
            (host_prep_webp) the same for the lossy and lossless WebP page
            fixtures (tests/data/webp_pages.json); and
            (native_cache) native/resample.cpp built with g++ in a
            subprocess under DSOCR_NATIVE_CACHE into an empty temporary
            directory, the library there and its resize of the page equal
            to this process's default build's;
4. serve    DeepSeek-OCR v1 at full width (DeepseekOcrConfig(), bf16
            weights from a seeded torch.Generator, int8 KV): 16 requests
            of 128 new tokens through ContinuousScheduler.submit over 16
            slots at the scheduler's defaults (speculative chunk dispatch
            on), 128-step chunks, on a seeded 1756×2852 page in 1024/640
            crop mode, after a warm-up of 2 requests × 8 tokens (the
            process's one: later bursts, each engine's first included, run
            warm). The launch counters are zeroed just before and read
            just after; every kernel of the bf16 path must have launched,
            the codes-in writes (slot_kv_update, paged_kv_update) not:
            every burst's decode step quantizes its token in the write.
            Every serving line (4-4h) gives the scheduler's
            speculated_chunks and stage_ms (the stage totals of a
            BenchRecorder installed for the burst).
            Then the profile of that engine at 16 rows (profile_phase):
            a prefill wave and decode steps, their host and device time,
            the kernel launches a decode step, the largest kernels, and
            the host time spent in the kernel
            wrappers against the rest of the step; and its tower line
            (tower_profile): the vision towers of TOWER_PAGES (8) pages, device ms, the
            SAM attention's share, host ms around the synchronized call;
    serve_spec  the same 16 requests at SPEC_MAX_NEW (64) tokens in
            SPEC_CHUNK (16)-step chunks, where the speculation gate opens
            (at 128-step chunks of 128 tokens it cannot):
            speculated_chunks must be > 0;
    sched   the same engine, 4 requests of 32 tokens in 8-step chunks:
            streamed against plain (equal tokens, each callback extending
            the last), the page twice with DSOCR_PREFIX_CACHE=4 (one hit,
            equal tokens, the hit's TTFT beside the miss's), max_inflight=2
            with 4 submitted (2 shed, 2 complete), one injected chunk fault
            (recoveries 1, tokens equal to the plain burst's), and the same
            with DSOCR_PAGED_KV=1 (every page back afterwards);
    split   the same engine's decoder in the reference's split layout (its
            state split; fusing it gives the engine's weights) over a
            contiguous KVCache: the page's 904-token packet prefilled, then
            16 greedy steps fed the fused decoder's tokens: logits
            bit-equal to the fused decoder's and the same greedy tokens;
            then moe_apply(gather_threshold=N), N = 2, 4, 16, at
            layer 1's experts against the same call on the CPU:
            gather_matmul must launch;
    decode  single-request decode, engine.decode of the page with
            DECODE_NEW (128) new greedy tokens: prompt tokens, prefill
            seconds, ms per step, tok/s, peak memory, with the card's name
            and power limit; for this bf16 engine, and again after 4c for
            the Q8_0 one. After the bf16 call, one more engine.decode of
            DEBUG_DECODE_NEW (8) tokens, neither counted nor timed, runs
            under the reference's debug knobs (debug_dumps: the vision
            dump's stages and shapes the reference's, the logits dump's
            `chosen` the token generated at DEBUG_LOGITS_STEP, its margin
            >= 0);
    towers_f32  the page's towers on this engine in bf16 and in f32 copies
            of its SAM and CLIP (DSOCR_VISION_F32's towers on the same
            weights): device ms of each, the card's used MiB, the largest
            |difference| of the projector output, and the f32 towers'
            sam_flash_attention launches (> 0);
    weights the same engine's weights written as an HF-named two-shard
            safetensors checkpoint with its config.json (write_checkpoint,
            ~6.7 GB in the ignored dsocr_tpu_torch/_build/weights/; the
            phase needs WEIGHTS_DISK free and fails without it), loaded
            through load_engine (bf16, int8 KV): every tensor, the page's
            prefill logits and engine.decode's 16 greedy tokens equal to
            the seeded engine's; then a Q8_0 and a Q6_K snapshot exported
            on the card by `dsq export`, each loaded through load_engine
            in its header's format: every packed tensor equal to the
            port's packing, on the card, of the floats it stands for
            (snapshot_floats); the Q6_K engine serves a 4 × 64 burst
            (`serve_q6k_snapshot`: the row matmul and the dense sweep must
            launch) and its profile; bytes and seconds of each write,
            export and load, free disk, peak host RSS and device GiB;
    frontends  on the weights phase's checkpoint and Q8_0 snapshot, before
            they are removed: config.json, a config.toml naming
            deepseek-ocr and deepseek-ocr-q8k (a temp
            DEEPSEEK_OCR_CACHE_DIR), a full-vocabulary DeepSeek-shaped
            tokenizer.json (synthetic_tokenizer) and the seeded page as a
            PNG (write_png) in a temp directory; `python -m
            dsocr_tpu_torch.server --device cuda` as a subprocess: the
            routes' shapes; a greedy 64-token chat request whose text and
            usage must equal the same request submitted alone to an
            in-process ContinuousScheduler over load_engine and
            load_tokenizer of the same files (the PNG decoded by
            image/decode.py bit-equal to the page); its streamed twin on
            /v1/responses (the deltas join to the text, the events in the
            reference's order); 4 requests and 2 streams of 128 tokens at
            once (all 200; pages/s, latency p50/max, time to the first
            delta); the swap to deepseek-ocr-q8k (model_swaps_total 2, the
            server's device memory lower after it); the baseline JPEG page
            fixture (tests/data/, the page's size) as a data:image/jpeg
            URL on deepseek-ocr-q8k, its text equal to an in-process
            scheduler's over the snapshot on decode_image of the JPEG and
            to the server's answer to the PNG of those pixels (both
            fixtures' digests equal Pillow's); the G4 TIFF page fixture
            the same way (text and usage); the lossy WebP page fixture as
            a data:image/webp URL, its text and usage equal to the
            in-process scheduler's on its decoded pixels; an unknown model, a prompt
            without an image, a broken and an arithmetic-coded JPEG and a
            JPEG-compressed TIFF (400s naming them), a body over 50 MB and
            a client leaving mid-stream; `python -m dsocr_tpu_torch.cli` on
            the JPEG page with --output-json (started after the swap,
            beside the server's last checks), its tokens equal to
            engine.decode's in-process on the decoded pixels.
            One line per check; the launches of the in-process runs count;
4b. serve_q8         the same with packed Q8_0 decoder weights (quantized
            on the card from the same seed): 16 requests × 128 tokens over
            16 slots, 16·6 = 96 selections > 64 experts, so decode runs the
            dense all-expert tier: q8_matmul, q8_dense_experts and
            q8_dense_experts_perx must launch, with the attention kernels;
            then its profile;
4c. serve_q8_gather  the same Q8_0 engine, 4 requests × 32 tokens over 4
            slots (24 selections ≤ 64): q8_gather_matmul must launch;
            then the same burst again under torch.profiler with every
            gather launch's idx kept (`_trace` line: the gather tier's
            device ms and launches, and the distinct experts of the
            launches of each selection count);
4d. serve_q4k        packed Q4_K decoder weights from the same seed (the
            routed experts' down projection, in dim 896, packs as Q8_0):
            8 requests × 128 tokens over 16 slots (the step's 16 rows
            select 96 experts), the dense tier:
            q4k_matmul, q4k_dense_experts and q8_dense_experts_perx must
            launch; then its profile;
4e. serve_q4k_gather the same Q4_K engine, 4 requests × 32 tokens over 4
            slots: q4k_gather_matmul and q8_gather_matmul must launch;
            then its `_trace` line;
4f. serve_q6k        packed Q6_K decoder weights from the same seed (the
            experts' down projection again Q8_0): 8 requests × 128 tokens
            over 16 slots, the dense tier: q6k_matmul, q6k_dense_experts
            and q8_dense_experts_perx must launch (its format's profile is
            serve_q6k_snapshot's, at the same shapes);
4g. serve_q6k_gather the same Q6_K engine, 4 requests × 32 tokens over 4
            slots: q6k_gather_matmul and q8_gather_matmul must launch;
            then its `_trace` line;
4h. serve_q8_paged   the Q8_0 engine of 4b with DSOCR_PAGED_KV=1,
            DSOCR_Q8_MEGAFUSED=1 and DSOCR_POOL_PAGES=108: 16 requests × 128
            tokens over 16 slots from a pool that holds 12 rows (9 pages of
            128 each), so 4 requests wait for pages. paged_kv_write,
            paged_decode_attention, q8_moe_megafused and q8_matmul must
            launch, the slot kernels, the codes-in writes and the
            two-kernel sweep must not; the
            line gives the pool's pages and bytes against the contiguous
            cache's, the occupancy, and how many requests' tokens equal 4b's
            (not required: megafused sums the experts in another order);
            then its profile, with a paged runner;
families  after 4g: DeepSeek-OCR2 and PaddleOCR-VL (families_phase).
            OCR2 at full width (ocr2_config: SAM with 896 output channels,
            the 24-layer Qwen2 encoder, the DeepSeek-V2 decoder), seeded,
            through load_engine on its config.json: the encoder's and
            SAM's device ms a page, then 4 requests × 32 tokens over 4
            slots of the page in 1024/768 crop mode (int8 KV):
            sam_flash_attention, flash_prefill_attention, slot_kv_write and
            slot_decode_attention must launch. OCR2 from files: the
            decoder cut to 2 layers (dense, MoE) with a router bias, SAM
            and the encoder at full depth (~2.8 GB in WEIGHTS_DIR), loaded
            through load_engine: the page's prefill logits bit-equal to a
            seeded engine's with the same bias; its Q8_0 snapshot (`dsq
            export`) serves one request (q8_matmul, q8_gather_matmul).
            PaddleOCR-VL at full width from files (~1.6 GB bf16): the file
            engine's 16 greedy tokens equal those of an engine built from
            the seeded state with its tower cast to f32, as the loader
            makes of the file; the page smart-resized to max_pixels (94 ×
            152 patches, 3,572 image tokens): the tower's ms a page, then
            4 pages × 32 tokens over 4 slots, and again from its Q8_0
            snapshot through the Paddle adapter (q8_matmul must launch).
            Then the server with a config.toml naming both families' files
            and synthetic tokenizer.jsons (DeepSeek-shaped for OCR2, a
            SentencePiece-shaped one at Paddle's 103,424 ids): one greedy
            chat request to each id (the second a swap, model_swaps_total
            counts both loads) equal in text and usage to the in-process
            scheduler over load_engine of the same files, and the CLI on
            Paddle's files against engine.decode. Every burst line gives
            pages/s, TTFT p50, prefill tokens, peak device memory and
            launches;
families2  after families: DotsOCR and GLM-OCR (families2_phase), each
            seeded at full width through load_engine on a written
            config.json (GLM's with its preprocessor_config.json), the
            f32 tower's weights rounded to bf16 values (what a published
            checkpoint holds), the seeded page at its pixel budget (Dots
            ~14,400 patches, 3,600 image tokens; GLM ~24,576 patches over
            two temporal frames, 6,144 image tokens): the tower's device ms
            a page, then 4 pages × 32 tokens over 4 slots (int8 KV, GLM's
            rows 8192 positions) after a one-request warm-up; Dots again
            with Q8_0 weights (q8_matmul must launch). Dots from files:
            the bf16 engine's checkpoint (the tower in bf16, ~5.5 GB in
            WEIGHTS_DIR) through load_engine, 16 greedy tokens equal to
            the seeded engine's, and its Q8_0 snapshot (`dsq export`
            through the Dots adapter) equal to the seeded Q8_0 engine's.
            GLM: a sampled request through ContinuousScheduler fails with
            the engine's ValueError; from files (~4.3 GB), 16 tokens equal
            to the seeded engine's. Then the server with a config.toml
            naming dots-ocr and glm-ocr (synthetic byte-level
            tokenizer.jsons at 151,936 and 59,392 ids with each family's
            special tokens, DSOCR_SLOT_SEQ 8192): one greedy chat request
            to each id (the second a swap) equal in text and usage to the
            in-process scheduler over load_engine of the same files, then
            the CLI on each against engine.decode. Every burst line gives
            pages/s, TTFT p50, the tower's ms a page, peak device memory
            and launches; the files lines their bytes and seconds;
            (h) of mesh_dense: a second server under --mesh dp=1,mp=2
            answers a 32-token dots-ocr request (MESH_SERVER_TEXT) with
            the in-process text, every top-2 margin of that answer's
            steps above MESH_LOGIT_TOL;
mesh      after 4h: DeepSeek-OCR v1 over two ranks sharing the card
            (mesh_phase: bf16 tensor-parallel with int8 KV, the same paged,
            Q8_0 expert-parallel), each burst against the single-process
            engine's (mesh_reference); the server under --mesh runs in
            frontends;
mesh_dense  after families2: PaddleOCR-VL, DotsOCR and GLM-OCR over two
            ranks sharing the card, one rank set (mesh_dense_phase,
            MESH_DENSE): (e) Paddle Q8_0 at dp=2 (slot rows over dp), (f)
            Dots Q8_0 and (g) GLM bf16 at mp=2 (KV heads over mp), 4 × 32
            over 4 slots, int8 KV, each held to the single-process burst
            on the same seeded weights taken in families (e) and families2
            (f, g) (mesh_reference: every top-2 margin above
            MESH_LOGIT_TOL); each case's line gives each rank's launches a
            step and a burst, collectives a step, peak MiB, slot-cache
            share, host ms a step, init_s and the least margin;
5. parity   the tiny config in f32 with one set of weights, served on the
            card (kernels) and on the CPU (twins), PARITY_NEW (8) tokens a
            request: greedy tokens must match;
            again with Q8_0 weights (moe_intermediate_size 32), and with
            Q4_K and with Q6_K weights (hidden 256, moe_intermediate_size
            32: K-quant gate+up, Q8_0 down), each at 2 slots (gather tier)
            and 4 slots (dense tier), f32 and int8 KV; and all-Q4_K and
            all-Q6_K experts (moe_intermediate_size 256) at 4 slots, the
            path that reaches q4k_/q6k_dense_experts_perx (DeepSeek's
            full-width down projection is Q8_0); and the Q8_0 config at 4
            slots with paged KV and the megafused chain, f32 and int8 KV,
            and with a pool of 2 pages, so that a request waits for pages;
            and engine.decode with and without the cache, f32 and Q8_0;
            and weights from files at hidden 256 (FILES_PARITY_SEED's
            checkpoint, its Q4_K and Q6_K snapshots exported on the card),
            loaded on the card and on the CPU: packed tensors bit-equal,
            greedy tokens equal at 4 slots with int8 KV; and the new
            families' tiny engines (family_parity: OCR2 behind the tiny
            Qwen2 encoder, PaddleOCR-VL, DotsOCR and GLM-OCR at 4 query
            heads over 2 KV heads) at 2 slots, f32 and int8 KV, at
            FAMILY_PARITY_SEED (held clear of near-ties by
            tests/test_torch_paddle.py and tests/test_torch_glm.py).

Every phase line carries t_s, the script's seconds when it was printed.
The seeded page's host prep (page_packet) runs once for the script;
outside the bursts' windows each phase reuses it.

Then a line with the script's total seconds, a {"kernels": [...]} summary
line (launches: the sum over the ten serving bursts, the sched phase, the
split phase, the two decode phases, the frontends phase's in-process
runs, the families and families2 phases' bursts and in-process
runs, and rank 0's in the mesh and mesh_dense bursts), the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
dsocr_tpu_torch package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
MAX_NEW = 128
N_REQUESTS = 16
N_SLOTS = 16
# the Q4_K and Q6_K bursts and the Q6_K snapshot's: 8 requests over the 16
# slots (the step still runs 16 rows, so the dense expert tier), cut from
# 16 for the time of the families2 phase
CUT_REQUESTS = 8
SNAPSHOT_BURST = (4, 64)  # serve_q6k_snapshot's requests × tokens (8 × 128 before the mesh_dense phase)
CHUNK = 128
# serve_spec's depth: half of phase 4's tokens, chunks a quarter of them
SPEC_MAX_NEW = 64
SPEC_CHUNK = 16
PROFILE_ROWS, PROFILE_WAVE, PROFILE_WINDOW = 16, 1024, 16  # rows, positions per row, steps
TOWER_PAGES = 8  # the profile's tower line: the towers of an 8-page burst (16 before the image-format lines)
PROMPT = "<image>\nFree OCR."
PARITY_SEED = 7
PARITY_NEW = 8  # phase 5's tokens a request (16 before the image-format lines; the seeds are clear over 16)
# Seed 7's Q6_K weights put a greedy near-tie in the int8-KV runs: summing
# the same bf16 products in another order flips a token, on the CPU as on
# the card. The Q6_K parity engines draw from seed 8, which
# tests/test_torch_q6k.py holds clear of such ties.
Q6K_PARITY_SEED = 8
# Phase 5's weights-from-files case draws from seed 9: seeds 7, 8, 11 and
# 12 put such a near-tie in its Q4_K or Q6_K run (int8 KV, 4 slots);
# tests/test_torch_loader.py holds 9 clear.
FILES_PARITY_SEED = 9
IMAGE_TOKEN_ID = 128815  # the DeepSeek tokenizer's <image> id
# phase 3's row-layout matmul cases (case, N, K, M), the same for every
# format; the lm_head first (the summary line takes its times)
# the weights phase's files (git-ignored): a full-width bf16 checkpoint
# (~6.7 GB) and one snapshot at a time (~3 GB)
WEIGHTS_DIR = os.path.join(HERE, "dsocr_tpu_torch", "_build", "weights")
WEIGHTS_DISK = 12 * 10 ** 9
ROW_CASES = (("lm_head", 16, 1280, 129280), ("qkv", 1, 1280, 3840), ("qkv", 16, 1280, 3840),
             ("qkv", 1024, 1280, 3840), ("qkv", 16384, 1280, 3840), ("shared_down", 16, 1792, 1280))


class BenchTokenizer:
    """Deterministic stand-in tokenizer (dsocr_tpu/bench/workload.py)."""

    def encode(self, text):
        return [(ord(c) * 7 + 13) % 120000 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def token_to_id(self, token):
        return IMAGE_TOKEN_ID if token == "<image>" else None


class TinyTokenizer:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def require(cond, message: str) -> None:
    """A failed check ends the run (raises; never skipped, unlike assert)."""
    if not cond:
        raise RuntimeError(message)


def emit(obj) -> None:
    """One JSON line; a phase's line also gets t_s, the script's seconds
    when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_us(event) -> float:
    """A torch.profiler event's own device microseconds."""
    value = getattr(event, "self_device_time_total", None)
    return float(value if value is not None else event.self_cuda_time_total)


def time_ms(fn, reps: int = 10, batches: int = 3) -> float:
    """Device milliseconds per fn() call: CUDA events around reps calls
    launched back to back behind a GPU sleep that outlasts their launching,
    so the host's time in a kernel wrapper (30-75 us a call, most of a small
    decode kernel's) is not counted; the median over batches, after a
    warm-up batch that also times the launching."""
    import torch

    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(host_s * 2e9 * 2) + 10 ** 6  # twice the launch time at <= 2 GHz
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense bf16 and TF32 tensor cores; f32 off them
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes the call must move (each input read once, each output
    written once) over the memory rate and its operations over the peak
    rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the reference's largest magnitude: both sides round
    their f32 result to bf16 once."""
    return float(ref.float().abs().max()) * 2.0 ** -7 + 1e-5


def q8_tol(bound) -> float:
    """f32 reassociation of exact bf16 products: 1e-5 of the largest sum of
    term magnitudes (|bf16 x| @ |W|)."""
    return float(bound.max()) * 1e-5


def megafused_tol(torch, x, weights, gu_codes, gu_scales, dn_codes, dn_scales):
    """Per-element tolerance of q8_moe_megafused [N, H] against another
    summation order of the same chain. In the down product and the combine,
    1e-5 of the sum of term magnitudes, as for the other Q8_0 kernels. In
    gate+up the sums (exact bf16 products, f32 adds) move by far less,
    ~1e-7 of it at these depths (3.3e-6 at H 768 on the CPU): what matters
    is whether that, allowed 1e-6 of the sum of magnitudes, and silu's own
    rounding, allowed 1e-6, can flip the bf16 rounding of an inter element.
    Where it can, the element may differ by one bf16 ulp, which |w|·|Wd|
    carries to the output."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16

    def deq(codes, scales):  # in-major [E, K, M] → f32 of bf16(code · scale)
        return (codes.float() * scales.repeat_interleave(32, dim=-2)).to(bf16).float()

    xb = x.to(bf16).float()[None]
    wgu = deq(gu_codes, gu_scales)
    gate, up = torch.chunk(torch.matmul(xb, wgu), 2, dim=-1)
    d_gate, d_up = torch.chunk(1e-6 * torch.matmul(xb.abs(), wgu.abs()), 2, dim=-1)
    del wgu
    act = F.silu(gate)
    pre = act * up
    slack = 1.1 * up.abs() * d_gate + act.abs() * d_up + 1e-6 * pre.abs()  # |silu'| < 1.1
    flips = ((pre + slack).to(bf16).float() - (pre - slack).to(bf16).float()).abs()
    terms = flips + 1e-5 * pre.to(bf16).float().abs()
    return (weights.abs()[:, :, None] * torch.matmul(terms, deq(dn_codes, dn_scales).abs())).sum(0) + 1e-6


def kv_tokens(torch, qkv, NKV, D):
    """The decoder's new K and V for a KV write from its projection qkv
    [B, 1, 3·NKV·D]: [B, NKV, 1, D] views of it, as DeepseekDecoder._qkv
    splits it (so not contiguous), with the quantizer's edge cases written
    in: row 0's first head all zeros (scale 0, safe 1); row 1's first head
    amax 127 (scale 1) and row 2's last head amax 63.5 (scale 0.5), their
    other values on rounding ties (x / scale = k + 0.5), exact in bf16."""
    B = qkv.shape[0]
    _, k, v = torch.split(qkv, NKV * D, dim=-1)
    k, v = (t.reshape(B, 1, NKV, D).transpose(1, 2) for t in (k, v))
    d = torch.arange(D, device=qkv.device, dtype=torch.float32)
    ties = (d % 200 - 100) + 0.5
    ties[0] = 127.0
    halves = ((d % 100) - 50) * 0.5 + 0.25
    halves[0] = 63.5
    for t, sign in ((k, 1.0), (v, -1.0)):
        if B > 0:
            t[0, 0, 0] = 0.0
        if B > 1:
            t[1, 0, 0] = sign * ties
        if B > 2:
            t[2, NKV - 1, 0] = sign * halves
    return k, v


def check_q8_kernels(torch, K, record, randn):
    """Phase 3, Q8_0: the four dequant-matmul wrappers against their twins
    at the main path's shapes, and the quantizer on the card against its
    CPU run."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    # lm_head 1280 → 129280 at N = 16; qkv 1280 → 3840 at one request's
    # decode, the 16-slot step, a 1024-row prefill and the 16 × 1024 wave;
    # shared down (K 1792) at the step. Two launches must give the same bits.
    for case, n, k, m in ROW_CASES:
        p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5))
        codes, scales = p["codes"], p["scales"]
        x = randn(n, k, dtype=torch.bfloat16)
        out = K.q8_matmul(x, codes, scales)
        require(torch.equal(out, K.q8_matmul(x, codes, scales)),
                f"q8_matmul {case} N={n}: two launches on the same inputs differ")
        ref = K.q8_matmul_plain(x, codes, scales)
        w = codes.float() * scales.repeat_interleave(32, dim=1)
        tol = q8_tol(torch.matmul(bf16_abs(x), w.abs().t()))
        wt = w.to(torch.bfloat16).t()
        del w
        record("q8_matmul", f"{case} N={n} K={k} M={m}", float((out - ref).abs().max()), tol,
               time_ms(lambda: K.q8_matmul(x, codes, scales)),
               time_ms(lambda: K.q8_matmul_plain(x, codes, scales)),
               time_ms(lambda: torch.matmul(x, wt)),
               bound(nbytes(x, codes, scales, out), 2 * n * k * m, "bf16"), deterministic=True)
        del out, ref, wt

    # expert stacks of one MoE layer: gate+up [64, 1280, 1792], down [64, 896, 1280]
    t0 = time.perf_counter()
    w_gu = randn(64, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5)
    gu = quantize_expert_stack(w_gu)
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    twin = quantize_expert_stack(w_gu.cpu())
    same = torch.equal(gu["codes"].cpu(), twin["codes"]) and torch.equal(gu["scales"].cpu(), twin["scales"])
    emit({"phase": "kernels", "kernel": "quantize_expert_stack", "case": "E=64 K=1280 M=1792 bf16",
          "bit_exact": same, "ms": quant_ms})
    require(same, "the Q8_0 quantizer on the card differs from its CPU run")
    del w_gu, twin
    dn = quantize_expert_stack(randn(64, 896, 1280, dtype=torch.bfloat16, std=896 ** -0.5))

    def deq(p):
        return p["codes"].float() * p["scales"].repeat_interleave(32, dim=1)

    check_expert_kernels(torch, record, randn, "q8", K.q8_gather_matmul, K.q8_gather_matmul_plain,
                         K.q8_dense_experts, K.q8_dense_experts_plain, K.q8_dense_experts_perx,
                         K.q8_dense_experts_perx_plain, gu, dn, deq, ("codes", "scales"))
    check_megafused(torch, K, record, randn, gu, dn)


def check_megafused(torch, K, record, randn, gu, dn):
    """q8_moe_megafused on one full-width MoE layer at N 16 (the serving
    step), 11 and 32 rows, routed top-6 by a seeded softmax router:
    per-element tolerance megafused_tol, two launches bit-equal; beside it
    the two-kernel sweep it replaces (q8_dense_experts, silu·up,
    q8_dense_experts_perx, the combine), sweep_ms. No single PyTorch call
    computes the chain: no library time."""
    import torch.nn.functional as F

    from dsocr_tpu_torch.ops.kernels import dequant_matmul

    def occupancy(*shape):  # what the card holds of the launch (None from a tree that cannot say)
        query = getattr(dequant_matmul, "q8_moe_megafused_occupancy", None)
        return query(*shape) if query else None

    E, topk = gu["codes"].shape[0], 6
    H, MI = gu["codes"].shape[1], dn["codes"].shape[1]
    for N in (16, 11, 32):
        x = randn(N, H, dtype=torch.bfloat16)
        weights, idx = torch.topk(torch.softmax(randn(N, E), dim=-1), topk, dim=-1)
        w = torch.zeros((E, N), device=x.device).index_put_(
            (idx.reshape(-1), torch.arange(N, device=x.device).repeat_interleave(topk)),
            weights.reshape(-1), accumulate=True)
        args = (x, w, gu["codes"], gu["scales"], dn["codes"], dn["scales"])
        out = K.q8_moe_megafused(*args)
        again = K.q8_moe_megafused(*args)
        require(torch.equal(out, again), f"q8_moe_megafused N={N}: two launches on the same inputs differ")
        ref = K.q8_moe_megafused_plain(*args)
        tol = megafused_tol(torch, *args)
        require(bool(((out - ref).abs() <= tol).all()),
                f"q8_moe_megafused N={N}: outside the per-element tolerance")

        def sweep():
            gates, ups = torch.chunk(K.q8_dense_experts(x, gu["codes"], gu["scales"]), 2, dim=-1)
            outs = K.q8_dense_experts_perx((F.silu(gates) * ups).to(x.dtype), dn["codes"], dn["scales"])
            sel = outs[idx, torch.arange(N, device=x.device)[:, None]]
            return (sel * weights[..., None]).sum(dim=1)

        record("q8_moe_megafused", f"N={N} E={E} H={H} MI={MI} top-{topk}", float((out - ref).abs().max()),
               float(tol.max()), time_ms(lambda: K.q8_moe_megafused(*args)),
               time_ms(lambda: K.q8_moe_megafused_plain(*args)), None,
               bound(nbytes(*args, out), 2 * E * N * (H * 2 * MI + MI * H), "bf16"),
               sweep_ms=time_ms(sweep), deterministic=True,
               clusters_resident_blocks_per_sm=occupancy(N, H, MI, E))
        del out, again, ref, tol


# the gather tier's draws timed in phase 3, (selections, top-6 sets): a
# top-6 of its own for each token at the burst's largest gather launch
# (10 rows × top-6), 4 serving slots and one request's decode; then 4 and
# 10 tokens that share one top-6, as identical requests route (the
# bursts here serve one page: their 24-selection launches hold 6–8
# distinct experts)
GATHER_DRAWS = ((60, 10), (24, 4), (6, 1), (24, 1), (60, 1))
GATHER_TOPK = 6


def routed_idx(torch, tokens, E, generator, sets=None):
    """A router's selections [tokens · top-6] int32: each token's experts
    distinct, `sets` top-6 draws (default one a token) taken in turn."""
    draws = [torch.randperm(E, generator=generator, device="cuda")[:GATHER_TOPK] for _ in range(sets or tokens)]
    return torch.stack([draws[t % len(draws)] for t in range(tokens)]).reshape(-1).to(torch.int32)


def gather_case(sel, sets):
    """The label of a GATHER_DRAWS entry."""
    return f"{sel} rows" + ("" if sets == sel // GATHER_TOPK else f" {sets} top-6")


def check_expert_kernels(torch, record, randn, fmt, gather, gather_plain, dense, dense_plain, perx,
                         perx_plain, gu, dn, deq, keys):
    """The gather, dense and per-expert wrappers of one format against
    their twins: gather at GATHER_DRAWS' routed selections of both
    stacks, the dense pair at N = 16 (csrc/expert_sweep.cu), each launched
    twice and bit-equal. `gu` and `dn` are packed [E, K, M] stacks (dn may
    be a stand-in), `deq` dequantizes one to f32 [E, K, M]. A gather's
    bound counts the bytes of the distinct experts it selects."""

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    gen_idx = torch.Generator(device="cuda").manual_seed(1)
    for case, p in (("gateup", gu), ("down", dn)):
        packed = tuple(p[key] for key in keys)
        w = deq(p)
        E, k, m = w.shape
        for sel, sets in GATHER_DRAWS:
            x = randn(sel, k, dtype=torch.bfloat16)
            idx = routed_idx(torch, sel // GATHER_TOPK, E, gen_idx, sets)
            out = gather(x, *packed, idx)
            require(torch.equal(out, gather(x, *packed, idx)),
                    f"{fmt}_gather_matmul {case} {gather_case(sel, sets)}: two launches on the same inputs differ")
            ref = gather_plain(x, *packed, idx)
            bnd = torch.bmm(bf16_abs(x)[:, None], w[idx.long()].abs())
            wg = w[idx.long()].to(torch.bfloat16)  # the library call gets its weights gathered
            used = torch.unique(idx).numel()  # bytes of the experts this run selects
            record(f"{fmt}_gather_matmul", f"{case} {gather_case(sel, sets)} E={E} K={k} M={m}",
                   float((out - ref).abs().max()), q8_tol(bnd),
                   time_ms(lambda: gather(x, *packed, idx)),
                   time_ms(lambda: gather_plain(x, *packed, idx)),
                   time_ms(lambda: torch.bmm(x[:, None], wg)),
                   bound(nbytes(x, idx, out) + nbytes(*packed) * used // E, 2 * sel * k * m, "bf16"),
                   deterministic=True, distinct_experts=used)
            del out, ref, bnd, wg
        del w

    packed = tuple(gu[key] for key in keys)
    w = deq(gu)
    E, k, m = w.shape
    x = randn(16, k, dtype=torch.bfloat16)
    out = dense(x, *packed)
    require(torch.equal(out, dense(x, *packed)),
            f"{fmt}_dense_experts: two launches on the same inputs differ")
    ref = dense_plain(x, *packed)
    wb = w.to(torch.bfloat16)
    record(f"{fmt}_dense_experts", f"gateup N=16 E={E} K={k} M={m}", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(x)[None], w.abs())),
           time_ms(lambda: dense(x, *packed)), time_ms(lambda: dense_plain(x, *packed)),
           time_ms(lambda: torch.matmul(x[None], wb)),
           bound(nbytes(x, out, *packed), 2 * E * 16 * k * m, "bf16"), deterministic=True)
    del out, ref, wb, w
    packed = tuple(dn[key] for key in keys)
    w = deq(dn)
    E, k, m = w.shape
    xe = randn(E, 16, k, dtype=torch.bfloat16)
    out = perx(xe, *packed)
    require(torch.equal(out, perx(xe, *packed)),
            f"{fmt}_dense_experts_perx: two launches on the same inputs differ")
    ref = perx_plain(xe, *packed)
    wb = w.to(torch.bfloat16)
    record(f"{fmt}_dense_experts_perx", f"down N=16 E={E} K={k} M={m}", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(xe), w.abs())),
           time_ms(lambda: perx(xe, *packed)), time_ms(lambda: perx_plain(xe, *packed)),
           time_ms(lambda: torch.matmul(xe, wb)),
           bound(nbytes(xe, out, *packed), 2 * E * 16 * k * m, "bf16"), deterministic=True)


KQUANT_CHECK_EXPERTS = 4  # the K-quant quantizers' check (8 before the image-format lines; its CPU run is the cost)


def check_kquant_kernels(torch, K, record, randn, method):
    """Phase 3, Q4_K or Q6_K: the four wrappers of the format against their
    twins at the main path's shapes (the per-expert sweep at a stand-in
    shape: DeepSeek's down projection is Q8_0), and the quantizer on the
    card against its CPU run on KQUANT_CHECK_EXPERTS experts of a
    full-width gate+up stack."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain
    from dsocr_tpu_torch.ops.kernels import kquant_matmul

    fmt = method.replace("_", "")  # q4k, q6k
    parts = kquant_matmul.Q4K_PARTS if method == "q4_k" else kquant_matmul.Q6K_PARTS
    keys = tuple(name for name, _, _ in parts)
    dequant = getattr(kquant_matmul, f"dequant_{fmt}")
    matmul, matmul_plain = getattr(K, f"{fmt}_matmul"), getattr(K, f"{fmt}_matmul_plain")

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    # the Q8_0 row cases (check_q8_kernels); two launches must give the same bits
    for case, n, k, m in ROW_CASES:
        p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5), method)
        packed = tuple(p[key] for key in keys)
        x = randn(n, k, dtype=torch.bfloat16)
        out = matmul(x, *packed)
        require(torch.equal(out, matmul(x, *packed)),
                f"{fmt}_matmul {case} N={n}: two launches on the same inputs differ")
        ref = matmul_plain(x, *packed)
        w = dequant(*packed, -1).float()
        tol = q8_tol(torch.matmul(bf16_abs(x), w.abs().t()))
        wt = w.to(torch.bfloat16).t()
        del w
        record(f"{fmt}_matmul", f"{case} N={n} K={k} M={m}", float((out - ref).abs().max()), tol,
               time_ms(lambda: matmul(x, *packed)),
               time_ms(lambda: matmul_plain(x, *packed)),
               time_ms(lambda: torch.matmul(x, wt)),
               bound(nbytes(x, out, *packed), 2 * n * k * m, "bf16"), deterministic=True)
        del out, ref, wt

    w8 = randn(KQUANT_CHECK_EXPERTS, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = quantize_expert_stack(w8, method)
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    twin = quantize_expert_stack(w8.cpu(), method)
    same = all(torch.equal(card[key].cpu(), twin[key]) for key in keys)
    emit({"phase": "kernels", "kernel": "quantize_expert_stack",
          "case": f"{method} E={KQUANT_CHECK_EXPERTS} K=1280 M=1792 bf16",
          "bit_exact": same, "ms": quant_ms})
    require(same, f"the {method} quantizer on the card differs from its CPU run")
    del w8, card, twin

    gu = quantize_expert_stack(randn(64, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5), method)
    dn = quantize_expert_stack(randn(64, 1792, 1280, dtype=torch.bfloat16, std=1792 ** -0.5), method)

    def deq(p):
        return dequant(*(p[key] for key in keys), -2).float()

    kernels = [getattr(K, f"{fmt}_{name}{suffix}") for name in ("gather_matmul", "dense_experts",
                                                                "dense_experts_perx")
               for suffix in ("", "_plain")]
    check_expert_kernels(torch, record, randn, fmt, *kernels, gu, dn, deq, keys)


def check_kernels(torch, K):
    """Phase 3: every kernel against its twin at main-path shapes."""
    import torch.nn.functional as F

    from dsocr_tpu_torch.ops.kernels import _lib

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0, generator=None):
        return (torch.randn(shape, generator=generator or gen, device=dev) * std).to(dtype)

    cases = []

    def record(kernel, case, err, tol, ms, plain_ms, library_ms, bnd, **extra):
        line = {"phase": "kernels", "kernel": kernel, "case": case, "max_abs_err": err,
                "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], **extra}
        emit(line)
        require(err <= tol, f"{kernel} {case}: max abs err {err} > tol {tol}")
        cases.append(line)

    # SAM global attention: one 1024 global view (S = 4096, 1 view x 12
    # heads), one page's six 640 tiles (S = 1600, 72), and, last, the
    # engine's launches: 4 views (BH 48) and 16 tiles (BH 192) a call; q
    # pre-scaled, f32. Two launches must give the same bits. The bound is
    # 3xTF32 on the tensor cores (three TF32 products per f32 product, as
    # the kernel computes); the f32 FMA bound stands beside it. The launch
    # shapes draw from a generator of their own and run after every other
    # kernel, so the other cases' inputs, and the device memory they find
    # (the plain twin at BH 48 allocates ~13 GB), do not depend on them.
    def check_sam(bh, s, src):  # a square grid of S = W² keys
        w = int(round(s ** 0.5))
        q, k, v = (randn(bh, s, 64, std=std, generator=src) for std in (0.125, 1.0, 1.0))
        bias_h, bias_w = (randn(bh, s, w, std=0.3, generator=src) for _ in range(2))
        args = (q, k, v, bias_h, bias_w)
        out = K.sam_flash_attention(*args, width=w)
        require(torch.equal(out, K.sam_flash_attention(*args, width=w)),
                "sam_flash_attention: two launches on the same inputs differ")
        ref = K.sam_flash_attention_plain(*args, width=w)
        err = float((out - ref).abs().max())
        del ref
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(bh, s, s)
        flops = 4 * bh * s * s * 64
        record("sam_flash_attention", f"BH={bh} S={s}", err, 1e-4,
               time_ms(lambda: K.sam_flash_attention(*args, width=w)),
               time_ms(lambda: K.sam_flash_attention_plain(*args, width=w)),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)),
               bound(nbytes(*args, out), 3 * flops, "tf32"),
               bound_f32_fma_ms=bound(nbytes(*args, out), flops, "f32")[0], deterministic=True)

    check_sam(12, 4096, gen)
    check_sam(72, 1600, gen)

    # decoder prefill: 10 heads of 128, bf16: S = 1792 with left padding;
    # the profile's wave (16 rows of 1024, no padding); pads at the tile
    # boundaries 63, 64, 65. Two launches must give the same bits.
    for b, pads, s in ((1, [0], 1792), (4, [0, 300, 7, 1000], 1792), (16, [0] * 16, 1024),
                       (3, [63, 64, 65], 256)):
        q, k, v = (randn(b, 10, s, 128, dtype=torch.bfloat16) for _ in range(3))
        pad = torch.tensor(pads, dtype=torch.int32, device=dev)
        scale = 128 ** -0.5
        out = K.flash_prefill_attention(q, k, v, pad, scale=scale)
        require(torch.equal(out, K.flash_prefill_attention(q, k, v, pad, scale=scale)),
                "flash_prefill_attention: two launches on the same inputs differ")
        ref = K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)
        err = float((out.float() - ref.float()).abs().max())
        pos = torch.arange(s, device=dev)
        mask = (pos[None, None, :, None] >= pos[None, None, None, :]) & (
            pos[None, None, None, :] >= pad[:, None, None, None])
        # a live query attends keys pad..i; a fully padded one averages all S
        keys = sum(p * s + (s - p) * (s - p + 1) // 2 for p in pads)
        label = f"pad_start={pads}" if any(pads) else "no pads"
        record("flash_prefill_attention", f"B={b} S={s} {label}", err, bf16_tol(ref),
               time_ms(lambda: K.flash_prefill_attention(q, k, v, pad, scale=scale)),
               time_ms(lambda: K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)),
               bound(nbytes(q, k, v, pad, out), 4 * 10 * 128 * keys, "bf16"), deterministic=True)
        del mask, q, k, v, out, ref

    # slot caches: L = 12, B = 16, NKV = 10, D = 128, S_max = 2560
    L, B, NKV, S, D = 12, 16, 10, 2560, 128
    lengths = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 0, S - 1
    layer = 5
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        if quant:
            def codes(*shape):
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

            k_all, v_all = codes(L, B, NKV, S, D), codes(L, B, NKV, S, D)
            ks_all = randn(L, B, NKV, S).abs() * 0.02
            vs_all = randn(L, B, NKV, S).abs() * 0.02
            k_new, v_new = codes(B, NKV, D), codes(B, NKV, D)
            ks_new, vs_new = randn(B, NKV).abs() * 0.02, randn(B, NKV).abs() * 0.02
        else:
            k_all, v_all = randn(L, B, NKV, S, D, dtype=torch.bfloat16), randn(L, B, NKV, S, D, dtype=torch.bfloat16)
            ks_all = vs_all = ks_new = vs_new = None
            k_new, v_new = randn(B, NKV, D, dtype=torch.bfloat16), randn(B, NKV, D, dtype=torch.bfloat16)
        caches = (k_all, v_all, ks_all, vs_all)
        twins = tuple(None if t is None else t.clone() for t in caches)
        new = (k_new, v_new, ks_new, vs_new)
        K.slot_kv_update(*caches, *new, layer, lengths)
        K.slot_kv_update_plain(*twins, *new, layer, lengths)
        same = all(a is None or torch.equal(a, b) for a, b in zip(caches, twins))
        # no single PyTorch call writes the four planes: no library time
        record("slot_kv_update", f"{kind} B={B} S={S}", 0.0 if same else float("inf"), 0.0,
               time_ms(lambda: K.slot_kv_update(*caches, *new, layer, lengths)),
               time_ms(lambda: K.slot_kv_update_plain(*twins, *new, layer, lengths)),
               None, bound(2 * nbytes(*new) + nbytes(lengths), 0, "bf16"))

        check_slot_attend(torch, K, record, randn, q=randn(B, 10, 1, D, dtype=torch.bfloat16),
                          caches=caches, layer=layer, lengths=lengths, case=f"{kind} B={B} S={S}")
    del k_all, v_all, ks_all, vs_all, caches, twins
    check_kv_writes(torch, K, record, randn, "slot", (L, B, NKV, S), D, lengths, layer)
    # the serving step (16 rows of the page's packet, 904 prompt tokens and
    # up to 128 new, in a 1536-position slot cache), then rows that end on
    # either side of a split boundary, and a row of one position
    split = _lib.DECODE_SPLIT
    edges = [0, split - 2, split - 1, split, split + 1, 2 * split - 1, 2 * split, 2 * split + 1]
    for case, lengths in (("serving", torch.randint(904, 904 + 128, (B,), generator=gen, device=dev,
                                                    dtype=torch.int32)),
                          ("split edges", torch.tensor(edges * 2, dtype=torch.int32, device=dev))):
        S = 1536
        for quant in (False, True):
            if quant:
                caches = (torch.randint(-127, 128, (1, B, NKV, S, D), generator=gen, device=dev,
                                        dtype=torch.int8),
                          torch.randint(-127, 128, (1, B, NKV, S, D), generator=gen, device=dev,
                                        dtype=torch.int8),
                          randn(1, B, NKV, S).abs() * 0.02, randn(1, B, NKV, S).abs() * 0.02)
            else:
                caches = (randn(1, B, NKV, S, D, dtype=torch.bfloat16),
                          randn(1, B, NKV, S, D, dtype=torch.bfloat16), None, None)
            check_slot_attend(torch, K, record, randn, q=randn(B, 10, 1, D, dtype=torch.bfloat16),
                              caches=caches, layer=0, lengths=lengths,
                              case=f"{'int8' if quant else 'bf16'} B={B} S={S} {case} "
                                   f"lengths {int(lengths.min())}-{int(lengths.max())}")
            del caches
    check_grouped_heads(torch, K, record, randn, gen)
    check_grouped_heads(torch, K, record, randn, gen, cases=MESH_GROUPED_HEADS, B=4, label="mesh rank")
    check_rows(torch, K, record, randn)
    check_rows(torch, K, record, randn, "paddle", PADDLE_ROW_CASES, methods=("q8_0",))
    check_gather_matmul(torch, K, record, randn, gen)
    check_paged_kernels(torch, K, record, randn, gen)
    check_q8_kernels(torch, K, record, randn)
    torch.cuda.empty_cache()
    for method in ("q4_k", "q6_k"):
        check_kquant_kernels(torch, K, record, randn, method)
        torch.cuda.empty_cache()
    launch_gen = torch.Generator(device=dev).manual_seed(1)
    check_sam(48, 4096, launch_gen)
    check_sam(192, 1600, launch_gen)
    torch.cuda.empty_cache()
    # the 1280 view's 80 × 80 grid (S 6400: one view's 12 heads, and the
    # engine's 4-view launch), and 128 × 128, past the shared-memory budget
    # of the staged bias rows (the kernel reads the bias per score there)
    for bh, s in ((12, 6400), (48, 6400), (2, 16384)):
        check_sam(bh, s, launch_gen)
        torch.cuda.empty_cache()
    return cases


GROUPED_PREFILL = ((1, [0], 3700), (4, [0, 300, 7, 1000], 3700))
# the grouped-head cases: (family, query heads, KV heads, layers, slot
# positions, prefill cases (B, pad starts, S)). PaddleOCR-VL's ratio 8 at a
# page's ~3,700-token prompt; DotsOCR's 12 over 2 (ratio 6) and GLM-OCR's
# 16 over 8 (ratio 2) at ~3,700 and ~6,200 tokens, Dots' and GLM's pages
GROUPED_HEADS = (
    ("paddle", 16, 2, 18, 4096, GROUPED_PREFILL),
    ("dots", 12, 2, 28, 4096, GROUPED_PREFILL + ((1, [0], 6200), (4, [0, 300, 7, 1000], 6200))),
    ("glm", 16, 8, 24, 8192, GROUPED_PREFILL + ((1, [0], 6200), (4, [0, 300, 7, 1000], 6200))),
)


# a mesh rank's heads in the mesh_dense phase (dp=1, mp=2): PaddleOCR-VL's
# 16 over 2 as 8 over 1, DotsOCR's 12 over 2 as 6 over 1, GLM-OCR's 16 over
# 8 as 8 over 4; the 4-row prefill wave of a burst (no pads) and the step
# of its 4 slots
MESH_GROUPED_HEADS = (
    ("paddle", 8, 1, 18, 4096, ((4, [0, 0, 0, 0], 3700),)),
    ("dots", 6, 1, 28, 4096, ((4, [0, 0, 0, 0], 3700),)),
    ("glm", 8, 4, 24, 8192, ((4, [0, 0, 0, 0], 6200),)),
)


def check_grouped_heads(torch, K, record, randn, gen, cases=GROUPED_HEADS, B=16, label="grouped"):
    """The attention kernels at the grouped heads of the new families
    (`cases`: GROUPED_HEADS, or a mesh rank's MESH_GROUPED_HEADS; D 128,
    bf16): flash_prefill_attention at a page's prompt, one row and four
    with left pads; then slot_kv_write and slot_decode_attention on the
    family's slot cache (L layers, B rows, bf16 and int8, lengths 0 and S −
    1 among them). Each against its twin, two launches bit-equal, library
    time SDPA with enable_gqa (none for the int8 attend or the writes). The
    twin and SDPA (an [S, S] mask) are timed over 2 × 2 calls."""
    import torch.nn.functional as F

    dev = "cuda"
    D = 128
    scale = D ** -0.5
    for family, H, HKV, L, S, prefills in cases:
        for b, pads, s in prefills:
            q = randn(b, H, s, D, dtype=torch.bfloat16)
            k, v = (randn(b, HKV, s, D, dtype=torch.bfloat16) for _ in range(2))
            pad = torch.tensor(pads, dtype=torch.int32, device=dev)
            out = K.flash_prefill_attention(q, k, v, pad, scale=scale)
            require(torch.equal(out, K.flash_prefill_attention(q, k, v, pad, scale=scale)),
                    f"flash_prefill_attention ({family} grouped): two launches on the same inputs differ")
            ref = K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)
            err, tol = float((out.float() - ref.float()).abs().max()), bf16_tol(ref)
            del ref
            pos = torch.arange(s, device=dev)
            mask = (pos[None, None, :, None] >= pos[None, None, None, :]) & (
                pos[None, None, None, :] >= pad[:, None, None, None])
            keys = sum(p * s + (s - p) * (s - p + 1) // 2 for p in pads)
            pads_label = f"pad_start={pads}" if any(pads) else "no pads"
            slow = dict(reps=2, batches=2)  # the twin's [S, S] f32 scores and SDPA's mask: seconds a case
            record("flash_prefill_attention", f"{label} {family} H={H}/{HKV} B={b} S={s} {pads_label}", err, tol,
                   time_ms(lambda: K.flash_prefill_attention(q, k, v, pad, scale=scale)),
                   time_ms(lambda: K.flash_prefill_attention_plain(q, k, v, pad, scale=scale), **slow),
                   time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                                                  enable_gqa=True), **slow),
                   bound(nbytes(q, k, v, pad, out), 4 * H * D * keys, "bf16"), deterministic=True)
            del mask, q, k, v, out
            torch.cuda.empty_cache()
        lengths = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = 0, S - 1
        layer = L // 2 - 2
        check_kv_writes(torch, K, record, randn, "slot", (L, B, HKV, S), D, lengths, layer)
        for quant in (False, True):
            if quant:
                caches = tuple(torch.randint(-127, 128, (L, B, HKV, S, D), generator=gen, device=dev,
                                             dtype=torch.int8) for _ in range(2))
                caches += tuple(randn(L, B, HKV, S).abs() * 0.02 for _ in range(2))
            else:
                caches = tuple(randn(L, B, HKV, S, D, dtype=torch.bfloat16) for _ in range(2)) + (None, None)
            check_slot_attend(torch, K, record, randn, q=randn(B, H, 1, D, dtype=torch.bfloat16), caches=caches,
                              layer=layer, lengths=lengths,
                              case=f"{label} {family} NH={H}/{HKV} {'int8' if quant else 'bf16'} L={L} B={B} "
                                   f"S={S}")
            del caches
        torch.cuda.empty_cache()


# DotsOCR's packed decoder at the row matmuls (case, N, K, M): qkv, gate/up,
# down (K 8,960: 35 K-quant super-blocks, an odd count) and the untied
# lm_head, at one request's step, the 16-slot step and a 1024-row prefill
DOTS_ROW_CASES = tuple((case, n, k, m) for case, k, m in (("qkv", 1536, 2048), ("gateup", 1536, 17920),
                                                          ("down", 8960, 1536), ("lm_head", 1536, 151936))
                       for n in (1, 16, 1024))


# PaddleOCR-VL's packed decoder under the mesh_dense phase's dp=2: q8_matmul
# on a rank's 2 of 4 slot rows, and on 4 (a replicated row, or dp 1)
PADDLE_ROW_CASES = tuple((case, n, k, m) for case, k, m in (("qkv", 1024, 2560), ("o", 2048, 1024),
                                                            ("gateup", 1024, 6144), ("down", 3072, 1024))
                         for n in (2, 4))


def check_rows(torch, K, record, randn, family="dots", cases=DOTS_ROW_CASES, methods=("q8_0", "q4_k", "q6_k")):
    """q8_matmul, q4k_matmul and q6k_matmul (`methods`) at a family's row
    cases (case, N, K, M) against their twins (tolerance q8_tol), two
    launches bit-equal, library time torch.matmul on the dequantized bf16
    weight."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_plain
    from dsocr_tpu_torch.ops.kernels import kquant_matmul

    for method in methods:
        fmt = {"q8_0": "q8", "q4_k": "q4k", "q6_k": "q6k"}[method]
        matmul, plain = getattr(K, f"{fmt}_matmul"), getattr(K, f"{fmt}_matmul_plain")
        for case, n, k, m in cases:
            p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5), method)
            if method == "q8_0":
                packed = (p["codes"], p["scales"])
                w = p["codes"].float() * p["scales"].repeat_interleave(32, dim=1)
            else:
                parts = kquant_matmul.Q4K_PARTS if method == "q4_k" else kquant_matmul.Q6K_PARTS
                packed = tuple(p[name] for name, _, _ in parts)
                w = getattr(kquant_matmul, f"dequant_{fmt}")(*packed, -1).float()
            x = randn(n, k, dtype=torch.bfloat16)
            out = matmul(x, *packed)
            require(torch.equal(out, matmul(x, *packed)),
                    f"{fmt}_matmul {family} {case} N={n}: two launches on the same inputs differ")
            err = float((out - plain(x, *packed)).abs().max())
            tol = q8_tol(torch.matmul(x.float().abs(), w.abs().t()))
            wt = w.to(torch.bfloat16).t()
            del w
            record(f"{fmt}_matmul", f"{family} {case} N={n} K={k} M={m}", err, tol,
                   time_ms(lambda: matmul(x, *packed)), time_ms(lambda: plain(x, *packed), reps=3),
                   time_ms(lambda: torch.matmul(x, wt)),
                   bound(nbytes(x, out, *packed), 2 * n * k * m, "bf16"), deterministic=True)
            del out, wt, p, packed
        torch.cuda.empty_cache()


def check_kv_writes(torch, K, record, randn, layout, lead, D, lengths, layer, tables=None):
    """The KV writes from the decoder's token (slot_kv_write or
    paged_kv_write: the int8 quantization in the kernel's body) on caches
    of shape `lead` + [D] (slot [L, B, NKV, S], paged [L, P, NKV, page]),
    int8 and bf16, tokens bf16 (the model's) and f32 from kv_tokens (the
    projection's views, an all-zero row and rounding ties): every plane
    torch.equal to the twin's (quantize_kv_int8, or the cast, then the
    plain write) on the same card. Beside the kernel's time, route_ms: the
    decode step's write before the kernel quantized, quantize_kv_int8 on K
    and V (about 11 PyTorch launches each) and the codes-in kernel
    (slot_kv_update / paged_kv_update). Bound: the token read once, the
    codes (or values), scales and the row map's int32s written or read
    once. No single PyTorch call does the write: no library time."""
    from dsocr_tpu_torch.ops.attention import quantize_kv_int8

    dev = "cuda"
    B, NKV = lengths.shape[0], lead[2]
    write = getattr(K, f"{layout}_kv_write")
    twin = getattr(K, f"{layout}_kv_write_plain")
    update = getattr(K, f"{layout}_kv_update")
    where = (layer, lengths) if tables is None else (tables, lengths, layer)
    for kind, token in (("int8", torch.bfloat16), ("bf16", torch.bfloat16), ("int8", torch.float32)):
        if kind == "int8":
            caches = [torch.randint(-127, 128, (*lead, D), device=dev, dtype=torch.int8) for _ in range(2)]
            caches += [randn(*lead).abs() * 0.02 for _ in range(2)]
        else:
            caches = [randn(*lead, D, dtype=torch.bfloat16) for _ in range(2)] + [None, None]
        twins = [None if c is None else c.clone() for c in caches]
        k, v = kv_tokens(torch, randn(B, 1, 3 * NKV * D, dtype=token), NKV, D)
        write(*caches, k, v, *where)
        twin(*twins, k, v, *where)
        same = all(a is None or torch.equal(a, b) for a, b in zip(caches, twins))
        del twins

        def route():
            if kind == "int8":
                (kq, ks), (vq, vs) = quantize_kv_int8(k[:, :, 0]), quantize_kv_int8(v[:, :, 0])
                new = (kq, vq, ks, vs)
            else:
                new = (k[:, :, 0].to(caches[0].dtype).contiguous(), v[:, :, 0].to(caches[0].dtype).contiguous(),
                       None, None)
            update(*caches, *new, *where)

        written = 2 * B * NKV * (D * caches[0].element_size() + (4 if kind == "int8" else 0))
        map_bytes = nbytes(lengths) + (nbytes(tables) if tables is not None else 0)
        record(f"{layout}_kv_write", f"{kind} cache, {str(token)[6:]} token B={B} {layout} {list(lead)}",
               0.0 if same else float("inf"), 0.0,
               time_ms(lambda: write(*caches, k, v, *where)), time_ms(lambda: twin(*caches, k, v, *where)),
               None, bound(2 * B * NKV * D * k.element_size() + written + map_bytes, 0, "bf16"),
               route_ms=time_ms(route), bit_exact=same)
        del caches


def check_slot_attend(torch, K, record, randn, *, q, caches, layer, lengths, case):
    """slot_decode_attention on one layer of `caches` against its twin
    (tolerance bf16_tol), two launches bit-equal; library time SDPA over
    the whole bf16 row under the length mask (none for int8: SDPA takes no
    int8 cache); bound: the K/V rows [0, lengths[b]] (and their int8
    scales) read once."""
    import torch.nn.functional as F

    k_all, v_all, ks_all, vs_all = caches
    B, NH, _, D = q.shape
    NKV, S = k_all.shape[2], k_all.shape[3]
    scale = D ** -0.5
    out = K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)
    require(torch.equal(out, K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)),
            f"slot_decode_attention {case}: two launches on the same inputs differ")
    ref = K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)
    err = float((out.float() - ref.float()).abs().max())
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    quant = ks_all is not None
    kv_bytes = used * NKV * D * k_all.element_size() * 2 + (used * NKV * 4 * 2 if quant else 0)
    library = None
    if not quant:
        live = (torch.arange(S, device=q.device)[None, :] <= lengths.long()[:, None])[:, None, None, :]
        kl, vl = k_all[layer], v_all[layer]
        library = time_ms(lambda: F.scaled_dot_product_attention(q, kl, vl, attn_mask=live, scale=scale,
                                                                 enable_gqa=NH != NKV))
    record("slot_decode_attention", case, err, bf16_tol(ref),
           time_ms(lambda: K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)),
           time_ms(lambda: K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)),
           library, bound(nbytes(q, lengths, out) + kv_bytes, 4 * NH * D * used, "bf16"),
           deterministic=True)


L2_BYTES = 50e6  # the H100's L2 cache


def cold_stacks(w, read_bytes: float):
    """w and enough copies of it that, taken in turn, the calls between two
    uses of one copy read twice the L2 (read_bytes a call): each call finds
    its slabs in device memory, as a layer's call would."""
    return [w] + [w.clone() for _ in range(math.ceil(2 * L2_BYTES / read_bytes))]


def in_turn(fn, stacks):
    """A call of fn on each of `stacks` in turn."""
    turn = itertools.cycle(stacks)
    return lambda: fn(next(turn))


def check_gather_matmul(torch, K, record, randn, gen):
    """Phase 3, gather_matmul: the split layout's expert gather at full
    width, gate/up [N·6, 1280] × [64, 1280, 896] and down [N·6, 896] ×
    [64, 896, 1280], for 16 and 2 tokens at top-6 (96 and 12 rows, experts
    repeated across tokens), one row, and 96 rows on 4 experts (tasks past
    16 selections of one expert), bf16 and f32 stacks. Tolerance 1e-5 ·
    max(|x| @ |W|) (f32 sums in another order); two launches bit-equal.
    Bound: the distinct selected experts' slabs, each read once, over
    3.35 TB/s (the line gives the per-row bytes too); library: index_select
    of the selected slabs and one bmm, which the port never calls. The
    kernel and the library are timed hot (ms, library_ms: the same stack
    every call, its slabs in the L2 where they fit) and cold (ms_cold,
    library_ms_cold: cold_stacks in turn)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        stacks = {"gateup": randn(64, 1280, 896, dtype=dtype, std=1280 ** -0.5),
                  "down": randn(64, 896, 1280, dtype=dtype, std=896 ** -0.5)}
        draws = []
        for rows in (96, 12):
            logits = randn(rows // 6, 64)
            draws.append((f"{rows} rows", torch.topk(logits, 6, dim=-1).indices.reshape(-1).to(torch.int32)))
        four = torch.randperm(64, generator=gen, device="cuda")[:4]
        draws.append(("96 rows on 4 experts",
                      four[torch.randint(0, 4, (96,), generator=gen, device="cuda")].to(torch.int32)))
        draws.append(("1 row", torch.randint(0, 64, (1,), generator=gen, device="cuda", dtype=torch.int32)))
        for label, idx in draws:
            for case, w in stacks.items():
                cases.append((dtype, label, case, w, idx))
    for dtype, label, case, w, idx in cases:
        E, H, I = w.shape
        rows = idx.numel()
        x = randn(rows, H, dtype=dtype)
        out = K.gather_matmul(x, w, idx)
        require(torch.equal(out, K.gather_matmul(x, w, idx)),
                "gather_matmul: two launches on the same inputs differ")
        ref = K.gather_matmul_plain(x, w, idx)
        tol = q8_tol(torch.bmm(x.float().abs()[:, None], w[idx.long()].float().abs()))
        distinct = torch.unique(idx).numel()
        slab = H * I * w.element_size()
        copies = cold_stacks(w, distinct * slab)
        record("gather_matmul", f"{case} {label} E={E} H={H} I={I} {str(dtype)[6:]}",
               float((out - ref).abs().max()), tol,
               time_ms(lambda: K.gather_matmul(x, w, idx)),
               time_ms(lambda: K.gather_matmul_plain(x, w, idx)),
               time_ms(lambda: torch.bmm(x[:, None], w.index_select(0, idx))),
               bound(nbytes(x, idx, out) + distinct * slab, 2 * rows * H * I,
                     "bf16" if dtype == torch.bfloat16 else "f32"),
               ms_cold=time_ms(in_turn(lambda s: K.gather_matmul(x, s, idx), copies)),
               library_ms_cold=time_ms(in_turn(lambda s: torch.bmm(x[:, None], s.index_select(0, idx)),
                                               copies)),
               stacks_cold=len(copies), distinct_experts=distinct, bytes_per_row_slabs=rows * slab,
               bytes_distinct_slabs=distinct * slab, deterministic=True)
        del out, ref, copies
    del cases, stacks
    torch.cuda.empty_cache()


def check_paged_kernels(torch, K, record, randn, gen):
    """Phase 3, paged KV: the write and the attend at the main path's
    shapes, 16 rows of the page's packet (904 prompt tokens, up to 128 new)
    holding 9 pages of 128 each in a pool of 144 (L 12, NKV 10, D 128),
    with int8 and bf16 pools. The library time of the bf16 attend is SDPA
    over each row's pages gathered contiguously outside the timing."""
    import torch.nn.functional as F

    dev = "cuda"
    L, B, NKV, D, page, P_max, per_row = 12, 16, 10, 128, 128, 12, 9
    P = B * per_row
    tables = torch.full((B, P_max), -1, dtype=torch.int32, device=dev)
    tables[:, :per_row] = torch.randperm(P, generator=gen, device=dev).reshape(B, per_row).int()
    lengths = torch.randint(904, 904 + 128, (B,), generator=gen, device=dev, dtype=torch.int32)
    layer = 5
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    for quant in (True, False):
        kind = "int8" if quant else "bf16"
        if quant:
            def codes(*shape):
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

            pools = [codes(L, P, NKV, page, D), codes(L, P, NKV, page, D),
                     randn(L, P, NKV, page).abs() * 0.02, randn(L, P, NKV, page).abs() * 0.02]
            new = (codes(B, NKV, D), codes(B, NKV, D), randn(B, NKV).abs() * 0.02,
                   randn(B, NKV).abs() * 0.02)
        else:
            pools = [randn(L, P, NKV, page, D, dtype=torch.bfloat16),
                     randn(L, P, NKV, page, D, dtype=torch.bfloat16), None, None]
            new = (randn(B, NKV, D, dtype=torch.bfloat16), randn(B, NKV, D, dtype=torch.bfloat16),
                   None, None)
        twins = [None if t is None else t.clone() for t in pools]
        K.paged_kv_update(*pools, *new, tables, lengths, layer)
        K.paged_kv_update_plain(*twins, *new, tables, lengths, layer)
        same = all(a is None or torch.equal(a, b) for a, b in zip(pools, twins))
        del twins
        # no single PyTorch call writes the four planes through a table: no library time
        record("paged_kv_update", f"{kind} B={B} P={P} page={page}", 0.0 if same else float("inf"),
               0.0, time_ms(lambda: K.paged_kv_update(*pools, *new, tables, lengths, layer)),
               time_ms(lambda: K.paged_kv_update_plain(*pools, *new, tables, lengths, layer)),
               None, bound(2 * nbytes(*new) + nbytes(tables, lengths), 0, "bf16"))

        q = randn(B, 10, D)
        scale = D ** -0.5
        out = K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)
        require(torch.equal(out, K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)),
                "paged_decode_attention: two launches on the same inputs differ")
        ref = K.paged_decode_attention_plain(q, *pools, tables, lengths, layer, scale=scale)
        kv_bytes = used * NKV * D * pools[0].element_size() * 2 + (used * NKV * 4 * 2 if quant else 0)
        library = None  # SDPA takes no int8 cache
        if not quant:
            ids = tables.long().clamp(min=0)
            rows = [pools[i][layer][ids].transpose(1, 2).reshape(B, NKV, P_max * page, D) for i in (0, 1)]
            live = (torch.arange(P_max * page, device=dev)[None, :] <= lengths.long()[:, None])[:, None, None, :]
            qb = q.to(torch.bfloat16)[:, :, None]
            library = time_ms(lambda: F.scaled_dot_product_attention(qb, *rows, attn_mask=live, scale=scale))
            del rows
        # f32 throughout: reassociation, the online rescaling and expf
        record("paged_decode_attention", f"{kind} B={B} ~{used // B} tokens/row", float((out - ref).abs().max()),
               float(ref.abs().max()) * 1e-4 + 1e-6,
               time_ms(lambda: K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)),
               time_ms(lambda: K.paged_decode_attention_plain(q, *pools, tables, lengths, layer, scale=scale)),
               library, bound(nbytes(q, tables, lengths, out) + kv_bytes, 4 * 10 * D * used, "f32"),
               deterministic=True)
        del pools, new
        torch.cuda.empty_cache()
    # a row without a page writes nothing: the last row's table is emptied
    tables[-1] = -1
    check_kv_writes(torch, K, record, randn, "paged", (L, P, NKV, page), D, lengths, layer, tables=tables)


def seeded_page():
    """The benchmark page: a seeded random page at sample_1.png's size, in
    1024/640 crop mode (904 prompt tokens)."""
    import numpy as np

    from dsocr_tpu_torch.core import VisionSettings

    image = np.random.default_rng(0).integers(0, 256, size=(1756, 2852, 3), dtype=np.uint8)
    return image, VisionSettings(base_size=1024, image_size=640, crop_mode=True)


_PAGE_INPUT = []


def page_input(engine):
    """The seeded page's VisionInput: the host prep (the host_prep phase
    read 0.11 s a page with the native resampler and 3.2 s with its NumPy
    twin on the host of an H100 80GB HBM3 machine) does not depend on the
    engine, so it runs once per script."""
    if not _PAGE_INPUT:
        _PAGE_INPUT.append(engine.prepare_vision_input(*seeded_page()))
    return _PAGE_INPUT[0]


def page_packet(engine):
    """The seeded page through `engine` outside a measured window → (image,
    vision, tokens, image mask, image embedding)."""
    image, vision = seeded_page()
    vin = page_input(engine)
    emb = engine.compute_image_embedding(vin)
    tokens, mask = engine.build_prompt_tokens(BenchTokenizer(), PROMPT, [vin], [emb], vision)
    return image, vision, tokens, mask, emb


HOST_PREP_SIZES = ((37, 53, 128, 96), (1756, 2852, 1, 1), (641, 1283, 639, 311), (900, 700, 1280, 1920))


def host_prep_phase(torch, engine, pages=N_REQUESTS):
    """Host image prep on the card's host. The seeded page through
    engine.prepare_vision_input with the native resampler and with its
    NumPy twin (resize_bicubic_numpy swapped in): the global view and every
    tile bit-equal, and HOST_PREP_SIZES (source H, W → output W, H) of
    seeded images resized both ways bit-equal; the seconds a page of each
    (the native's median of 3, the twin's one run); then a 16-page prep wave through the engine's prefill
    (its thread pool of up to 8; slot.prepare_inputs of a BenchRecorder,
    towers and prefill after it not counted), and os.cpu_count()."""
    import numpy as np

    from dsocr_tpu_torch.core.benchmark import BenchRecorder, set_recorder
    from dsocr_tpu_torch.image import resample

    image, vision = seeded_page()

    def prep_seconds(runs):
        times, vin = [], None
        for _ in range(runs):
            t0 = time.perf_counter()
            vin = engine.prepare_vision_input(image, vision)
            times.append(time.perf_counter() - t0)
        return statistics.median(times), times, vin

    native_s, native_runs, native_vin = prep_seconds(3)
    native = resample.resize_bicubic_native
    resample.resize_bicubic_native = resample.resize_bicubic_numpy
    try:
        twin_s, twin_runs, twin_vin = prep_seconds(1)  # one run: the NumPy twin is the slow path
    finally:
        resample.resize_bicubic_native = native
    rng = np.random.default_rng(5)
    sizes_equal = []
    for h, w, ow, oh in HOST_PREP_SIZES:
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        sizes_equal.append(bool(np.array_equal(resample.resize_bicubic(img, ow, oh),
                                               resample.resize_bicubic_numpy(img, ow, oh))))
    rec = BenchRecorder()
    set_recorder(rec)
    try:
        engine.prefill_for_slots(BenchTokenizer(), [(PROMPT, [image], vision)] * pages)
    finally:
        set_recorder(None)
    wave_s = rec.stage_totals()["slot.prepare_inputs"] / 1e3
    line = {"phase": "host_prep", "cpu_count": os.cpu_count(),
            "tiles": len(native_vin.patches), "crop_shape": list(native_vin.crop_shape),
            "global_view_equal": bool(np.array_equal(native_vin.global_pixels, twin_vin.global_pixels)),
            "tiles_equal": bool(np.array_equal(native_vin.patches, twin_vin.patches)),
            "sizes_equal": sizes_equal,
            "prepare_s_per_page_native": native_s, "prepare_s_per_page_twin": twin_s,
            "prepare_s_runs_native": native_runs, "prepare_s_runs_twin": twin_runs,
            "wave_pages": pages, "wave_prep_s": wave_s, "wave_prep_s_per_page": wave_s / pages}
    emit(line)
    require(line["global_view_equal"] and line["tiles_equal"] and all(sizes_equal),
            "the native resize differs from its NumPy twin")
    host_prep_jpeg()
    host_prep_formats()
    host_prep_pnm()
    host_prep_webp()
    native_cache_check()


def decode_fixtures(meta):
    """The page fixtures `meta` lists (page_fixtures), each decoded on the
    host 3 times → ({name: bytes, shape, the median and each run's ms, the
    pixels' sha256 equal to Pillow's}, {name: pixels})."""
    import hashlib

    files, pixels = {}, {}
    for name, (raw, entry) in page_fixtures(meta).items():
        pixels[name], ms, runs = decode_timed(raw)
        files[name] = {"bytes": len(raw), "shape": list(pixels[name].shape), "decode_ms": ms, "decode_ms_runs": runs,
                       "sha256_equal": hashlib.sha256(pixels[name].tobytes()).hexdigest() == entry["sha256"]}
    return files, pixels


def host_prep_jpeg():
    """The JPEG page fixtures decoded on the host (image/decode.py over
    native/jpeg.cpp, decode_fixtures); the PNG of the baseline's pixels
    decoded the same way; beside os.cpu_count() and the card."""
    import numpy as np

    files, pixels = decode_fixtures("jpeg_pages.json")
    baseline = pixels["page_baseline.jpg"]
    png = png_bytes(baseline)
    png_pixels, png_ms, png_runs = decode_timed(png)
    jpeg_line = {"phase": "host_prep_jpeg", "cpu_count": os.cpu_count(), "nvidia_smi": smi_line(), "files": files,
                 "png_of_baseline_bytes": len(png), "png_decode_ms": png_ms, "png_decode_ms_runs": png_runs,
                 "png_equal": bool(np.array_equal(png_pixels, baseline))}
    emit(jpeg_line)
    require(all(f["sha256_equal"] for f in files.values()) and jpeg_line["png_equal"],
            "a JPEG page fixture decoded to other pixels than Pillow's")


def host_prep_formats():
    """The TIFF, BMP and GIF page fixtures decoded on the host
    (image/{tiff,bmp,gif}.py over native/{tiff,bmp,gif,tiff_color,jpeg}.cpp,
    decode_fixtures; the YCbCr 4:2:0 JPEG-in-TIFF page among them), beside
    os.cpu_count(), the card, and whether the host's Python has the
    standard library's lzma (LZMA-compressed TIFF strips need it)."""
    t0 = time.perf_counter()
    try:
        import lzma  # noqa: F401

        lzma_imports = True
    except ImportError:
        lzma_imports = False
    files, _ = decode_fixtures("format_pages.json")
    emit({"phase": "host_prep_formats", "cpu_count": os.cpu_count(), "nvidia_smi": smi_line(), "files": files,
          "lzma_imports": lzma_imports, "seconds": time.perf_counter() - t0})
    require(all(f["sha256_equal"] for f in files.values()),
            "a TIFF, BMP or GIF page fixture decoded to other pixels than Pillow's")
    require(lzma_imports, "host_prep_formats: the standard library's lzma does not import on this host")


def host_prep_pnm():
    """The PNM and Zstandard TIFF page fixtures decoded on the host
    (image/pnm.py over native/pnm.cpp, image/tiff.py over native/zstd.cpp;
    decode_fixtures), and the pages tests/data/make_pnm_pages.py's numpy
    writers build from committed fixtures (P6, 16-bit P5 and plain P2 of
    the LZW page's pixels, the baseline JPEG page as an old-style JPEG
    TIFF, read through native/jpeg.cpp's raw data units and
    native/tiff_color.cpp), each decoded 3 times against Pillow's sha256,
    beside os.cpu_count() and the card."""
    import hashlib

    from dsocr_tpu_torch.image.decode import decode_image

    t0 = time.perf_counter()
    files, _ = decode_fixtures("pnm_pages.json")
    sys.path.insert(0, JPEG_PAGES)
    try:
        from make_pnm_pages import built_pages
    finally:
        sys.path.remove(JPEG_PAGES)
    with open(os.path.join(JPEG_PAGES, "pnm_pages.json")) as fh:
        entries = json.load(fh)["built"]
    lzw = decode_image(page_fixtures("format_pages.json")["page_lzw.tif"][0])
    baseline = page_fixtures("jpeg_pages.json")["page_baseline.jpg"][0]
    built = {}
    for name, (raw, source) in built_pages(lzw, baseline).items():
        pixels, ms, runs = decode_timed(raw)
        built[name] = {"source": source, "bytes": len(raw), "shape": list(pixels.shape), "decode_ms": ms,
                       "decode_ms_runs": runs,
                       "sha256_equal": hashlib.sha256(pixels.tobytes()).hexdigest() == entries[name]["sha256"]}
    emit({"phase": "host_prep_pnm", "cpu_count": os.cpu_count(), "nvidia_smi": smi_line(), "files": files,
          "built": built, "seconds": time.perf_counter() - t0})
    require(all(f["sha256_equal"] for f in files.values()) and all(f["sha256_equal"] for f in built.values())
            and set(built) == set(entries), "a PNM, Zstandard TIFF or old-style JPEG TIFF page decoded to other "
            "pixels than Pillow's")


def host_prep_webp():
    """The WebP page fixtures decoded on the host (image/webp.py over
    native/webp_{lossless,lossy}.cpp, decode_fixtures), beside
    os.cpu_count() and the card."""
    t0 = time.perf_counter()
    files, _ = decode_fixtures("webp_pages.json")
    emit({"phase": "host_prep_webp", "cpu_count": os.cpu_count(), "nvidia_smi": smi_line(), "files": files,
          "seconds": time.perf_counter() - t0})
    require(all(f["sha256_equal"] for f in files.values()),
            "a WebP page fixture decoded to other pixels than Pillow's")


_NATIVE_CACHE_CHILD = """
import hashlib, sys
sys.path.insert(0, {here!r})
from chip_smoke import seeded_page
from dsocr_tpu_torch.native import resample as N
image, _ = seeded_page()
out = N.resize_bicubic_native(image, 1024, 640)
print(N.library_path())
print(hashlib.sha256(out.tobytes()).hexdigest())
"""


def native_cache_check():
    """DSOCR_NATIVE_CACHE: a subprocess with the knob set to an empty
    temporary directory builds native/resample.cpp there (g++) and resizes
    the seeded page; the library must land there and the pixels equal
    this process's default build's."""
    import hashlib
    import shutil
    import tempfile

    from dsocr_tpu_torch.native import resample as N

    image, _ = seeded_page()
    want = hashlib.sha256(N.resize_bicubic_native(image, 1024, 640).tobytes()).hexdigest()
    cache = tempfile.mkdtemp(prefix="native-cache-")
    try:
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", _NATIVE_CACHE_CHILD.format(here=HERE)], capture_output=True,
                               text=True, timeout=300, env=dict(os.environ, DSOCR_NATIVE_CACHE=cache))
        seconds = time.perf_counter() - t0
        out = child.stdout.split()
        built = out[0] if child.returncode == 0 and len(out) == 2 else None
        ok = (built is not None and os.path.dirname(built) == cache and os.path.exists(built) and out[1] == want
              and os.path.dirname(str(N.library_path())) != cache)
        emit({"phase": "native_cache", "ok": ok, "returncode": child.returncode, "seconds": seconds,
              "library_in_cache": built is not None and os.path.dirname(built) == cache,
              "pixels_equal_default_build": built is not None and out[1] == want})
        if not ok:
            print(child.stderr[-4000:], file=sys.stderr)
        require(ok, "DSOCR_NATIVE_CACHE: the resampler did not build there, or its pixels differ")
    finally:
        shutil.rmtree(cache, ignore_errors=True)


class InjectedFault(RuntimeError):
    """The sched phase's injected chunk fault: the one exception it expects."""


def sched_phase(torch, K, engine, n_requests=4, max_new=32, chunk=8):
    """The scheduler's serving features at full width on the bf16 engine:
    n_requests requests of the seeded page, max_new greedy tokens, over
    n_requests slots, chunks of `chunk` steps, prefill waves of one request.
    Checks, each against the plain burst's tokens: every request streamed
    (each callback's list extends the one before, and the last is the
    tokens); the page twice, one after the other, with DSOCR_PREFIX_CACHE=4
    (one hit; the hit's TTFT beside the miss's); max_inflight=2 with
    n_requests submitted at once (two shed with QueueDepthExceeded, two
    complete); one injected chunk fault (recoveries 1, every request
    completes with the plain burst's tokens); and the plain and faulted
    bursts again with DSOCR_PAGED_KV=1 (the faulted tokens equal the
    paged plain burst's, and every page back in the pool after each).

    The fault is injected on the first chunk, which raises before it runs:
    the row rejoins through the same one-row prefill and join as the
    plain burst, so its tokens are equal by construction. A later fault
    rejoins through a continuation prefill, which computes the generated
    tokens' K/V in the prefill's bf16 sums rather than the decode step's,
    so greedy tokens of random weights could part there; the CPU tests
    (tests/test_torch_scheduler.py) hold continuations at f32. Waves of one
    request: the recovery re-prefills one row, and cuBLAS may sum a wave of
    several rows in another order."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler, QueueDepthExceeded

    image, vision, tokens, _, _ = page_packet(engine)
    params = DecodeParameters(max_new_tokens=max_new)
    tok = BenchTokenizer()
    s_pad = -(-len(tokens) // 128) * 128
    max_len = -(-(s_pad + max_new) // 512) * 512

    def scheduler(**kw):
        return ContinuousScheduler(engine, tok, n_slots=n_requests, max_len=max_len, chunk_steps=chunk,
                                   prefill_batch=1, **kw)

    def burst(sched, n=n_requests, stream=None, exceptions=False):
        async def run():
            return await asyncio.gather(*(
                sched.submit(PROMPT, [image], vision, params,
                             stream_cb=None if stream is None else stream(i)) for i in range(n)),
                return_exceptions=exceptions)

        return asyncio.run(run())

    def inject(sched):
        sched._ensure_state()
        run = sched._runner.run_chunk_snap
        calls = []

        def chunk_call(*args):
            calls.append(1)
            if len(calls) == 1:
                raise InjectedFault("injected chunk fault")
            return run(*args)

        sched._runner.run_chunk_snap = chunk_call

    K.reset_launches()
    t0 = time.perf_counter()
    plain = scheduler()
    want = [o.generated_tokens for o in burst(plain)]
    line = {"phase": "sched", "requests": n_requests, "max_new": max_new, "chunk": chunk,
            "tokens_per_request": [len(t) for t in want], "plain_speculated_chunks": plain.speculated_chunks}

    seen = {i: [] for i in range(n_requests)}
    streamed_sched = scheduler()
    streamed = [o.generated_tokens for o in burst(
        streamed_sched, stream=lambda i: (lambda n, toks: seen[i].append(list(toks))))]
    extends = all(b[: len(a)] == a and len(b) > len(a) for calls in seen.values()
                  for a, b in zip(calls, calls[1:]))
    line.update(stream_equal=streamed == want, stream_callbacks=[len(c) for c in seen.values()],
                stream_extends=extends, stream_last_equal=[c[-1] if c else None for c in seen.values()] == want,
                stream_speculated_chunks=streamed_sched.speculated_chunks)

    with environ(DSOCR_PREFIX_CACHE="4"):
        cached = scheduler()
    miss = burst(cached, n=1)[0].generated_tokens
    hit = burst(cached, n=1)[0].generated_tokens
    line.update(prefix_hits=cached.prefix_cache.hits, prefix_misses=cached.prefix_cache.misses,
                prefix_equal=miss == hit == want[0], ttft_miss_s=cached.ttft_samples[0],
                ttft_hit_s=cached.ttft_samples[1])

    capped = scheduler(max_inflight=2)
    outs = burst(capped, exceptions=True)
    shed = [o for o in outs if isinstance(o, QueueDepthExceeded)]
    done = [o for o in outs if not isinstance(o, BaseException)]
    line.update(shed=len(shed), shed_requests=capped.shed_requests, shed_completed=len(done),
                retry_after_s=[e.retry_after_s for e in shed])
    require(len(shed) + len(done) == len(outs), f"an unexpected failure under max_inflight: {outs}")

    faulted = scheduler()
    inject(faulted)
    got = [o.generated_tokens for o in burst(faulted)]
    line.update(recoveries=faulted.recoveries, recovered_equal=got == want)

    with environ(DSOCR_PAGED_KV="1"):
        paged_plain = scheduler()
        paged_want = [o.generated_tokens for o in burst(paged_plain)]
        paged_faulted = scheduler()
        inject(paged_faulted)
        paged_got = [o.generated_tokens for o in burst(paged_faulted)]
    pools = [(s._runner.allocator.free_count, s._cache.n_pages) for s in (paged_plain, paged_faulted)]
    line.update(paged_recoveries=paged_faulted.recoveries, paged_recovered_equal=paged_got == paged_want,
                paged_equal_to_contiguous=paged_want == want, paged_pages_free_after=pools,
                launches={k: v for k, v in K.launch_counts().items() if v},
                seconds=time.perf_counter() - t0)
    launches = K.launch_counts()
    emit(line)
    require(line["stream_equal"] and line["stream_extends"] and line["stream_last_equal"],
            "streamed tokens differ from the plain burst's or do not extend")
    require(all(n >= 2 for n in line["stream_callbacks"]), "a streamed request got fewer than 2 callbacks")
    require(line["stream_speculated_chunks"] == 0, "a chunk was speculated while rows streamed")
    require(line["prefix_hits"] == 1 and line["prefix_misses"] == 1 and line["prefix_equal"],
            "the prefix cache did not serve the second page from one hit with equal tokens")
    require(line["shed"] == 2 and line["shed_requests"] == 2 and line["shed_completed"] == 2,
            "max_inflight=2 did not shed two of four requests")
    require(line["recoveries"] == 1 and line["recovered_equal"], "the recovered burst differs")
    require(line["paged_recoveries"] == 1 and line["paged_recovered_equal"],
            "the recovered paged burst differs")
    require(all(free == total for free, total in pools), f"pages were not returned: {pools}")
    return launches


def split_state(torch, state, lang):
    """The fused decoder state_dict split into the reference's split layout
    (q/k/v, gate/up, shared gate/up, expert gate/up): fusing it gives
    `state` back."""
    NH, NKV, D, DV = lang.num_attention_heads, lang.resolved_kv_heads, lang.head_dim, lang.resolved_v_head_dim
    return split_fused(torch, state, {"qkv_proj": (("q_proj", "k_proj", "v_proj"), (NH * D, NKV * D, NKV * DV)),
                                      "gateup_proj": (("gate_proj", "up_proj"), None),
                                      "shared_gateup": (("shared_gate", "shared_up"), None),
                                      "experts_gateup": (("experts_gate", "experts_up"), None)})


def split_fused(torch, state, parts):
    """`state` with each fused entry of `parts` ({name: (split names, out
    sizes or None for halves, or [-1] to rename it to its one name)})
    split along its last dim."""
    out = {}
    for key, value in state.items():
        head, _, name = key.rpartition(".")
        if name not in parts:
            out[key] = value
            continue
        names, sizes = parts[name]
        if sizes == [-1]:  # a rename
            out[f"{head}.{names[0]}"] = value
            continue
        pieces = torch.split(value, sizes or value.shape[-1] // 2, dim=-1)
        out.update({f"{head}.{n}": p.contiguous() for n, p in zip(names, pieces)})
    return out


def config_json(cfg) -> dict:
    """A published-style config.json for `cfg` (DeepseekOcrConfig.from_dict
    reads it back: the language fields under language_config, SAM and CLIP,
    or for OCR2 SAM and the qwen2-0-5b encoder of a DeepEncoderV2, under
    vision_config.width, the projector). Only the full-width towers
    round-trip: the published format has no SAM window or neck width."""
    sam, clip = cfg.sam, cfg.clip
    width = {"sam_vit_b": {"image_size": sam.image_size, "patch_size": sam.patch_size, "width": sam.embed_dim,
                           "layers": sam.depth, "heads": sam.num_heads,
                           "downsample_channels": list(sam.out_channels),
                           "global_attn_indexes": list(sam.global_attn_indexes)}}
    vision = {"image_size": sam.image_size, "width": width}
    if cfg.variant == "ocr2":
        vision["model_name"] = "deepencoderv2"
        width["qwen2-0-5b"] = {"dim": sam.out_channels[1]}
    else:
        width["clip-l-14-224"] = {"width": clip.hidden_size, "layers": clip.num_layers, "heads": clip.num_heads,
                                  "image_size": clip.image_size, "patch_size": clip.patch_size}
    return {
        "architectures": ["DeepseekOCRForCausalLM"],
        "language_config": dataclasses.asdict(cfg.language),
        "vision_config": vision,
        "projector_config": {"projector_type": "linear", "n_embed": cfg.projector_n_embed,
                             "input_dim": cfg.projector_input_dim},
    }


def paddle_config_json(cfg) -> dict:
    """A published-style PaddleOCR-VL config.json (PaddleConfig.from_dict
    reads it back, the tiny config included: the M-RoPE sections under
    rope_scaling)."""
    data = dataclasses.asdict(cfg)
    data["rope_scaling"] = {"type": "mrope", "mrope_section": list(data.pop("mrope_section"))}
    data["architectures"] = ["PaddleOCRVLForConditionalGeneration"]
    return data


def hf_tensors(torch, state, cfg, ocr2=None):
    """A model state_dict (fused or split) → (HF checkpoint name, tensor)
    in the loader's table order: the loader's name map inverted (fused
    projections split, [in, out] linears and expert stacks transposed
    back to [out, in]); OCR2's encoder of `ocr2` (the published widths by
    default), the routers' biases where the state has them."""
    from dsocr_tpu_torch.models.deepseek.decoder import has_gate_bias
    from dsocr_tpu_torch.models.deepseek.loader import checkpoint_entries

    split = split_state(torch, state, cfg.language)
    for e in checkpoint_entries(cfg, ocr2=ocr2, gate_bias=has_gate_bias(state)):
        t = split[e.key]
        if e.experts:
            for j in range(e.experts):
                yield e.name.format(e=j), t[j].t()
        else:
            yield e.name, t.t() if e.transpose else t


def paddle_hf_tensors(torch, state, cfg):
    """A PaddleOCR-VL state_dict (fused or split) → (HF name, tensor) in
    the loader's table order (the patch linear back to its conv)."""
    from dsocr_tpu_torch.models.paddleocr.loader import checkpoint_entries

    D, NH, NKV = cfg.head_dim, cfg.num_attention_heads, cfg.resolved_num_key_value_heads
    split = split_fused(torch, state, {"qkv_proj": (("q_proj", "k_proj", "v_proj"), (NH * D, NKV * D, NKV * D)),
                                       "gateup_proj": (("gate_proj", "up_proj"), None)})
    v = cfg.vision_config
    for e in checkpoint_entries(cfg):
        t = split[e.key]
        if e.key == "vision.patch_embed.w":
            t = t.t().reshape(v.hidden_size, v.num_channels, v.patch_size, v.patch_size)
        yield e.name, t.t() if e.transpose else t


def dots_config_json(cfg) -> dict:
    """A published-style DotsOCR config.json: the Qwen2 fields at the top
    level, the tower under vision_config (DotsConfig.from_dict reads both,
    and the image and EOS ids; the DSQ adapter reads the top level)."""
    return {**dataclasses.asdict(cfg.text), "architectures": ["DotsOCRForCausalLM"],
            "vision_config": dataclasses.asdict(cfg.vision), "image_token_id": cfg.image_token_id,
            "eos_token_id": cfg.eos_token_id}


def glm_config_json(cfg) -> dict:
    """A published-style GLM-OCR config.json (text_config with its
    rope_parameters and EOS ids, vision_config, the scaffold's image and
    video ids); glm_preprocessor_json gives the file beside it."""
    text = dataclasses.asdict(cfg.text)
    text["rope_parameters"] = {"mrope_section": list(text.pop("mrope_section")),
                               "partial_rotary_factor": text.pop("partial_rotary_factor"),
                               "rope_theta": text.pop("rope_theta")}
    text["eos_token_id"] = list(text.pop("eos_token_ids"))
    return {"architectures": ["GlmOcrForConditionalGeneration"], "text_config": text,
            "vision_config": dataclasses.asdict(cfg.vision),
            **{key: getattr(cfg, key) for key in ("image_token_id", "image_start_token_id", "image_end_token_id",
                                                  "video_start_token_id", "video_end_token_id")}}


def glm_preprocessor_json(cfg) -> dict:
    return {"size": {"shortest_edge": cfg.min_pixels, "longest_edge": cfg.max_pixels},
            "image_mean": list(cfg.image_mean), "image_std": list(cfg.image_std)}


def dots_hf_tensors(torch, state, cfg):
    """A DotsOCR state_dict (fused or split) → (HF name, tensor) in the
    loader's table order."""
    from dsocr_tpu_torch.models.dots.loader import checkpoint_entries

    t = cfg.text
    sizes = (t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim,
             t.num_key_value_heads * t.head_dim)
    split = split_fused(torch, state, {"qkv_proj": (("q_proj", "k_proj", "v_proj"), sizes),
                                       "qkv_bias": (("q_bias", "k_bias", "v_bias"), sizes),
                                       "gateup_proj": (("gate_proj", "up_proj"), None)})
    for e in checkpoint_entries(cfg):
        yield e.name, split[e.key].t() if e.transpose else split[e.key]


def glm_hf_tensors(torch, state, cfg):
    """A GLM-OCR state_dict (fused or the reference's names) → (HF name,
    tensor) in the loader's table order (the patch linear back to its
    conv)."""
    from dsocr_tpu_torch.models.glm.loader import checkpoint_entries

    t, v = cfg.text, cfg.vision
    sizes = (t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim,
             t.num_key_value_heads * t.head_dim)
    split = split_fused(torch, state, {"qkv_proj": (("q_proj", "k_proj", "v_proj"), sizes),
                                       "qkv_bias": (("q_bias", "k_bias", "v_bias"), sizes),
                                       "gateup_proj": (("gate_up_proj",), [-1])})
    for e in checkpoint_entries(cfg):
        w = split[e.key]
        if e.key == "vision.patch_embed.w":
            w = w.t().reshape(v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
        yield e.name, w.t() if e.transpose else w


def write_checkpoint(torch, state, cfg, directory, shards=2, ocr2=None):
    """Write `state` as an HF-named safetensors shard set in `directory`
    (model-0000k-of-0000n.safetensors, split by bytes, and
    model.safetensors.index.json) with its config.json; → (index path,
    config path, bytes of tensor data). Each tensor is copied to the host
    on its own. A PaddleConfig writes a PaddleOCR-VL checkpoint, a
    DotsConfig a DotsOCR one and a GlmConfig a GLM-OCR one (with its
    preprocessor_config.json)."""
    family = type(cfg).__name__
    if family == "PaddleConfig":
        return write_tensors(torch, list(paddle_hf_tensors(torch, state, cfg)), paddle_config_json(cfg),
                             directory, shards)
    if family == "DotsConfig":
        return write_tensors(torch, list(dots_hf_tensors(torch, state, cfg)), dots_config_json(cfg), directory,
                             shards)
    if family == "GlmConfig":
        with open(os.path.join(directory, "preprocessor_config.json"), "w") as fh:
            json.dump(glm_preprocessor_json(cfg), fh)
        return write_tensors(torch, list(glm_hf_tensors(torch, state, cfg)), glm_config_json(cfg), directory,
                             shards)
    return write_tensors(torch, list(hf_tensors(torch, state, cfg, ocr2)), config_json(cfg), directory, shards)


def write_tensors(torch, tensors, config_data, directory, shards):
    """(name, tensor) pairs as a shard set with `config_data` as its
    config.json (write_checkpoint)."""
    import struct

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64",
             torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8"}
    total = sum(t.numel() * t.element_size() for _, t in tensors)
    weight_map, start = {}, 0
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        group, size = [], 0
        while start < len(tensors) and (size < total / shards or k == shards - 1):
            group.append(tensors[start])
            size += tensors[start][1].numel() * tensors[start][1].element_size()
            start += 1
        header, offset = {}, 0
        for name, t in group:
            n = t.numel() * t.element_size()
            header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)  # the data starts on an 8-byte boundary
        with open(os.path.join(directory, fname), "wb") as fh:
            fh.write(struct.pack("<Q", len(raw)) + raw)
            for _, t in group:
                fh.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    index = os.path.join(directory, "model.safetensors.index.json")
    with open(index, "w") as fh:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, fh)
    config = os.path.join(directory, "config.json")
    with open(config, "w") as fh:
        json.dump(config_data, fh)
    return index, config, total


def snapshot_floats(torch, state, cfg, reader, device):
    """The floats a snapshot stands for, in the fused layout: `state` (the
    checkpoint the snapshot was exported from), with each float fallback
    record's (F16) value in place of the checkpoint's, cast to the model
    dtype as the loader casts it."""
    from dsocr_tpu_torch.models.deepseek.decoder import fuse_decoder_params
    from dsocr_tpu_torch.models.deepseek.loader import checkpoint_entries

    split = split_state(torch, state, cfg.language)
    where = {}
    for e in checkpoint_entries(cfg):
        for j in range(e.experts) if e.experts else [None]:
            where[e.name.format(e=j) if e.experts else e.name] = (e.key, j)
    cloned = set()
    for rec in reader.records:
        if rec.q_dtype not in ("F16", "BF16", "F32"):
            continue
        key, j = where[f"{rec.name}.weight"]
        w = reader.dequantize(rec.name, torch.float32, device).t().to(split[key].dtype)
        if j is None:
            split[key] = w.contiguous()
            continue
        if key not in cloned:
            split[key] = split[key].clone()
            cloned.add(key)
        split[key][j] = w
    return fuse_decoder_params(split)


def host_rss_peak_gib() -> float:
    """The process's peak resident set so far (ru_maxrss, KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def export_snapshot(torch, index, config, path, method, device=None):
    """`python -m dsocr_tpu_torch.dsq export` of the checkpoint as a
    `method` snapshot (quantized on `device`, the card by default); its
    summary line goes to stderr. → seconds."""
    from dsocr_tpu_torch.dsq import cli as dsq_cli

    args = ["export", "--weights", index, "--config", config, "--dtype", method, "--model-id", "chip-smoke",
            "--output", path] + (["--device", device] if device else [])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        require(dsq_cli.main(args) == 0, f"dsq export {method} failed")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def file_engine(torch, cfg, index, snapshot, method, device, kv_quant=None):
    """The tiny config's f32 engine from a checkpoint and a snapshot on
    `device` (load_engine's path; config.json cannot carry the tiny
    towers' widths)."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine
    from dsocr_tpu_torch.models.deepseek.loader import load_deepseek_params

    state = load_deepseek_params(index, cfg, dtype=torch.float32, snapshot_path=snapshot, device=device)
    return DeepseekOcrEngine(cfg, dtype=torch.float32, device=device, max_seq_len=512, kv_quant=kv_quant,
                             state=state, quantize=method)


PACKED_PARTS = ("codes", "scales", "mins", "highs")


def prefill_logits(engine):
    """The page's packet through `engine`'s towers and prefill → logits."""
    _, _, tokens, mask, emb = page_packet(engine)
    return engine._prefill_rows([(tokens, mask, [emb])])[0]["logits"]


def weights_phase(torch, K, engine, required, unused, then=None):
    """Weights from files at full width, on phase 4's bf16 engine: its
    weights written as an HF-named two-shard safetensors checkpoint with its
    config.json (write_checkpoint), loaded through load_engine (bf16, int8
    KV): every tensor, the page's prefill logits and engine.decode's 32
    greedy tokens must equal the seeded engine's. Then `dsq export` of a
    Q8_0 and a Q6_K snapshot on the card, each loaded through load_engine
    in the header's format: every packed tensor must equal the port's own
    packing, on the card, of the floats it stands for (snapshot_floats);
    the Q6_K engine then serves a SNAPSHOT_BURST burst (its serving line and
    profile; the kernels in `required` must launch, none in `unused`). The line gives
    the bytes and seconds of each write, export and load, the free disk
    before the phase, peak host RSS and peak device GiB. The files live in
    WEIGHTS_DIR (git-ignored) and are removed at the end; too little free
    disk fails the phase. `then(index, config, q8_0 snapshot)`, when given,
    runs on the files before they go (the frontends phase). → [the burst's
    launch counts, then's]."""
    import collections
    import shutil

    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.core.engine import ModelKind
    from dsocr_tpu_torch.dsq.format import DsqReader
    from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params
    from dsocr_tpu_torch.models.registry import load_engine

    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    free = shutil.disk_usage(WEIGHTS_DIR).free
    line = {"phase": "weights", "disk_free_bytes": free, "host_rss_peak_before_gib": host_rss_peak_gib()}
    require(free >= WEIGHTS_DISK, f"{free} bytes free in {WEIGHTS_DIR}; the weights phase needs {WEIGHTS_DISK}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    failures = []

    def load(snapshot=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load_engine(ModelKind.DEEPSEEK, config_path=config, weights_path=index, snapshot_path=snapshot,
                          dtype="bfloat16", max_seq_len=engine.max_seq_len, kv_quant="int8")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        index, config, nbytes = write_checkpoint(torch, engine.model.state_dict(), engine.cfg, WEIGHTS_DIR)
        ckpt = line["checkpoint"] = {"bytes": nbytes, "write_s": time.perf_counter() - t0}
        loaded, ckpt["load_s"] = load()
        want, got = engine.model.state_dict(), loaded.model.state_dict()
        differ = sorted(k for k in set(want) | set(got) if k not in want or k not in got
                        or want[k].dtype != got[k].dtype or not torch.equal(want[k], got[k]))
        ckpt.update(tensors=len(want), tensors_differ=differ[:8])
        ckpt["prefill_logits_equal"] = torch.equal(*(prefill_logits(e) for e in (engine, loaded)))
        image, vision = seeded_page()
        decoded = [e.decode(BenchTokenizer(), PROMPT, [image], vision,
                            DecodeParameters(max_new_tokens=16)).generated_tokens for e in (engine, loaded)]
        ckpt.update(decode_tokens=len(decoded[1]), decode_tokens_equal=decoded[0] == decoded[1])
        failures += [] if not differ else ["the loaded checkpoint's tensors differ"]
        failures += [] if ckpt["prefill_logits_equal"] else ["the loaded checkpoint's prefill logits differ"]
        failures += [] if ckpt["decode_tokens_equal"] else ["the loaded checkpoint's decode tokens differ"]
        del loaded, want, got
        gc.collect()
        torch.cuda.empty_cache()

        launches = None
        for method in ("q8_0", "q6_k"):
            path = os.path.join(WEIGHTS_DIR, f"{method}.dsq")
            snap = line[method] = {"export_s": export_snapshot(torch, index, config, path, method),
                                   "bytes": os.path.getsize(path)}
            reader = DsqReader(path)
            snap["records"] = dict(collections.Counter(r.q_dtype for r in reader.records))
            loaded, snap["load_s"] = load(path)
            snap["quantize"] = loaded.quantize
            expected = quantize_decoder_params(
                snapshot_floats(torch, engine.model.state_dict(), engine.cfg, reader, "cuda"), method)
            got = loaded.model.state_dict()
            packed = [k for k in expected if k.rsplit(".", 1)[-1] in PACKED_PARTS]
            differ = [k for k in packed if k not in got or not torch.equal(expected[k], got[k])]
            snap.update(packed_tensors=len(packed), packed_differ=differ[:8])
            failures += [] if loaded.quantize == method else [f"the {method} snapshot served as {loaded.quantize}"]
            failures += [] if packed and not differ else [f"the {method} snapshot's packed tensors differ"]
            del expected, got
            reader.close()
            if method == "q6_k" and not failures:
                launches = serving_phase(torch, K, "serve_q6k_snapshot", loaded, n_requests=SNAPSHOT_BURST[0],
                                         n_slots=N_SLOTS, max_new=SNAPSHOT_BURST[1], required=required, unused=unused,
                                         warmup=False, profile=True)[0]
            del loaded
            gc.collect()
            torch.cuda.empty_cache()
            if method != "q8_0":
                os.remove(path)
        line.update(seconds=time.perf_counter() - t_phase, host_rss_peak_gib=host_rss_peak_gib(),
                    max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        emit(line)
        require(not failures, "; ".join(failures))
        out = [launches]
        if then is not None:
            out.append(then(index, config, os.path.join(WEIGHTS_DIR, "q8_0.dsq")))
    finally:
        shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    return out


# -- the front ends: a tokenizer.json and a PNG from the standard library, ---------
# -- the server and the CLI as subprocesses -------------------------------------------

# DeepSeek's pre-tokenizer regexes (its tokenizer.json): digit runs of up
# to three, CJK runs, then letters/marks, punctuation/symbols, whitespace
TOKENIZER_SPLITS = (
    r"\p{N}{1,3}",
    "[一-龥぀-ゟ゠-ヿ]+",
    r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+"
    r"| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
)
FRONTEND_MAX_NEW = 64
FRONTEND_BURST = 4  # non-streaming requests of the burst, beside 2 streaming ones (8 before families2)
SERVER_START_S = 120
REQUEST_S = 600


def byte_level_chars():
    """GPT-2's byte → printable character map, in byte order."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for _, c in sorted(zip(bs, cs))]


def synthetic_tokenizer(path, vocab_size, specials, seed=0, max_len=16):
    """Write a tokenizer.json of DeepSeek's shape: a byte-level BPE with the
    256 byte tokens and seeded random merges filling every id below
    `vocab_size` that `specials` ({id: content}) leaves free, the special
    tokens in the vocabulary at their ids and listed as added special
    tokens (as DeepSeek's file has them: the library takes an added
    token's id from the vocabulary), the Split pre-tokenizers of
    TOKENIZER_SPLITS and a ByteLevel decoder, so that every id decodes to
    text."""
    import random

    rng = random.Random(seed)
    tokens = byte_level_chars()
    seen, merges = set(tokens) | set(specials.values()), []
    while len(tokens) < vocab_size - len(specials):
        a = tokens[rng.randrange(len(tokens))]
        b = tokens[rng.randrange(256 if rng.random() < 0.75 else len(tokens))]
        if len(a) + len(b) <= max_len and a + b not in seen:
            seen.add(a + b)
            tokens.append(a + b)
            merges.append([a, b])
    ids = [i for i in range(vocab_size) if i not in specials]
    vocab = dict(zip(tokens, ids))
    vocab.update({content: i for i, content in specials.items()})
    split = [{"type": "Split", "pattern": {"Regex": rx}, "behavior": "Isolated", "invert": False}
             for rx in TOKENIZER_SPLITS]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True} for i, c in sorted(specials.items())],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": split + [
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    return path


def png_bytes(image) -> bytes:
    """An RGB uint8 [H, W, 3] image as an 8-bit truecolor PNG (filter 0)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = image.shape

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(image).reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path, image):
    """png_bytes of `image` written to `path` → the bytes."""
    data = png_bytes(image)
    with open(path, "wb") as fh:
        fh.write(data)
    return data


JPEG_PAGES = os.path.join(HERE, "tests", "data")  # written by tests/data/make_{jpeg,format,webp,pnm}_pages.py


def page_fixtures(meta):
    """The page fixtures a JSON of tests/data/ lists (jpeg_pages.json: the
    JPEG pages; format_pages.json: TIFF, BMP and GIF; webp_pages.json:
    WebP; pnm_pages.json: the P4 and Zstandard TIFF pages) → {name: (bytes,
    their entry: shape, bytes, the sha256 of Pillow's RGB)}."""
    with open(os.path.join(JPEG_PAGES, meta)) as fh:
        entries = json.load(fh)["files"]
    out = {}
    for name, entry in entries.items():
        with open(os.path.join(JPEG_PAGES, name), "rb") as fh:
            out[name] = (fh.read(), entry)
    return out


def decode_timed(raw, runs=3):
    """decode_image of `raw` `runs` times → (pixels, median ms, each run's ms)."""
    from dsocr_tpu_torch.image.decode import decode_image

    times, pixels = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        pixels = decode_image(raw)
        times.append((time.perf_counter() - t0) * 1e3)
    return pixels, statistics.median(times), times


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port, method, path, body=None, raw=None, timeout=REQUEST_S):
    """One request to 127.0.0.1:port → (status, headers, text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=payload, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def sse_call(port, path, body, timeout=REQUEST_S):
    """A streaming request → (status, events, seconds to the first content
    delta, seconds to the end)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        events, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                event = line[6:].decode().strip()
                events.append(event if event == "[DONE]" else json.loads(event))
                if first is None and event != "[DONE]" and sse_delta(events[-1]):
                    first = time.perf_counter() - t0
        return resp.status, events, first, time.perf_counter() - t0
    finally:
        conn.close()


def sse_delta(event) -> str:
    """The text an SSE event adds (chat or responses schema)."""
    if event.get("type") == "response.output_text.delta":
        return event["delta"]
    choices = event.get("choices") or [{}]
    return choices[0].get("delta", {}).get("content", "") or ""


def chat_body(model, url, max_tokens, stream=False, text="Free OCR."):
    content = [{"type": "text", "text": text}] + ([{"type": "image_url", "image_url": {"url": url}}] if url else [])
    return {"model": model, "stream": stream, "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": content}]}


def gpu_memory_mib(pid):
    """(the process's device MiB from nvidia-smi's compute apps or None,
    the card's used MiB)."""
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60).stdout
    mine = []
    for line in apps.strip().splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 2 and fields[0] == str(pid) and fields[1].isdigit():
            mine.append(int(fields[1]))
    total = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout
    return (mine[0] if mine else None), int(total.strip().splitlines()[0])


def frontends_phase(torch, K, index, config_path, q8_snapshot, required):
    """The server and the CLI at full width on the weights phase's files:
    the checkpoint (`index`, `config_path`) and its Q8_0 snapshot. Writes
    config.json, config.toml (deepseek-ocr and deepseek-ocr-q8k through a
    temp DEEPSEEK_OCR_CACHE_DIR), a full-vocabulary tokenizer.json
    (synthetic_tokenizer) and the seeded page as a PNG into a temp
    directory, starts `python -m dsocr_tpu_torch.server --device cuda` and
    checks: the routes' shapes; one greedy chat request's text and usage
    against the same request submitted alone to an in-process
    ContinuousScheduler over load_engine and load_tokenizer of the same
    files (the PNG decoded bit-equal to the page); its streamed twin on
    /v1/responses (the deltas join to the text, the events in the
    reference's order); a burst of 4 requests and 2 streams at once; the
    swap to the snapshot (model_swaps_total 2, the server's device memory
    lower after it than before); the JPEG page fixture and the G4 TIFF page
    fixture on the snapshot (timed before the CLI and the mesh server
    start, so the server has the card alone), each against an in-process
    scheduler over its pixels and the PNG of them, and the lossy WebP page
    fixture against the in-process scheduler; the error shapes (a broken and an
    arithmetic-coded JPEG and a JPEG-compressed TIFF among them); then
    the CLI's tokens on the JPEG page against engine.decode in-process.
    One line per check; the launch counts of the in-process runs are
    returned (`required` must launch)."""
    import base64
    import hashlib
    import shutil
    import socket
    import tempfile
    import threading

    import numpy as np

    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.core.engine import ModelKind
    from dsocr_tpu_torch.core.params import normalize_text
    from dsocr_tpu_torch.core.text import render_prompt
    from dsocr_tpu_torch.image.decode import decode_image
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig
    from dsocr_tpu_torch.models.registry import load_engine
    from dsocr_tpu_torch.utils.tokenizer import load_tokenizer

    cfg = DeepseekOcrConfig()
    lang = cfg.language
    tmp = tempfile.mkdtemp(prefix="frontends-", dir=WEIGHTS_DIR)
    server = cli = cli_pbm = mesh_server = None
    log_path = os.path.join(tmp, "server.log")
    launches = {}
    t_phase = time.perf_counter()

    def check(name, ok, **fields):
        emit({"phase": "frontends", "check": name, "ok": bool(ok), **fields})
        if not ok and server is not None:
            with open(log_path, errors="replace") as fh:
                print(fh.read(), file=sys.stderr)
        require(ok, f"frontends: {name} failed: {fields}")

    try:
        # the five files
        t0 = time.perf_counter()
        model_dir = os.path.join(tmp, "cache", "models")
        os.makedirs(os.path.join(model_dir, "deepseek-ocr-q8k"))
        os.replace(q8_snapshot, os.path.join(model_dir, "deepseek-ocr-q8k", "snapshot.dsq"))
        config = shutil.copy(config_path, os.path.join(tmp, "config.json"))
        tok_path = synthetic_tokenizer(os.path.join(tmp, "tokenizer.json"), lang.vocab_size, {
            lang.bos_token_id: "<｜begin▁of▁sentence｜>", lang.eos_token_id: "<｜end▁of▁sentence｜>",
            IMAGE_TOKEN_ID: "<image>"})
        page, vision = seeded_page()
        png = write_png(os.path.join(tmp, "page.png"), page)
        url = "data:image/png;base64," + base64.b64encode(png).decode()
        pages = page_fixtures("jpeg_pages.json")
        jpeg = pages["page_baseline.jpg"][0]
        g4 = page_fixtures("format_pages.json")["page_g4.tif"][0]
        g4_url = "data:image/tiff;base64," + base64.b64encode(g4).decode()
        ycc = page_fixtures("format_pages.json")["page_jpeg_ycc420.tif"][0]
        ycc_url = "data:image/tiff;base64," + base64.b64encode(ycc).decode()
        webp = page_fixtures("webp_pages.json")["page_lossy.webp"][0]
        webp_url = "data:image/webp;base64," + base64.b64encode(webp).decode()
        pbm = page_fixtures("pnm_pages.json")["page.pbm"][0]  # the G4 page's pixels as raw PBM (P4)
        pbm_url = "data:image/x-portable-bitmap;base64," + base64.b64encode(pbm).decode()
        with open(os.path.join(tmp, "page.pbm"), "wb") as fh:
            fh.write(pbm)
        with open(os.path.join(tmp, "page.jpg"), "wb") as fh:
            fh.write(jpeg)
        jpeg_url = "data:image/jpeg;base64," + base64.b64encode(jpeg).decode()
        paths = "".join(f'{key} = "{value}"\n' for key, value in
                        (("config", config), ("tokenizer", tok_path), ("weights", index)))
        toml = os.path.join(tmp, "config.toml")
        with open(toml, "w") as fh:
            fh.write('[models]\nactive = "deepseek-ocr"\n\n[inference]\ndevice = "cuda"\n\n'
                     f'[models.entries."deepseek-ocr"]\n{paths}\n[models.entries."deepseek-ocr-q8k"]\n{paths}')
        files_s = time.perf_counter() - t0

        # in-process: the same files through load_engine and load_tokenizer
        t0 = time.perf_counter()
        tokenizer = load_tokenizer(tok_path)
        engine = load_engine(ModelKind.DEEPSEEK, config_path=config, weights_path=index, max_seq_len=8192)
        load_s = time.perf_counter() - t0
        decoded = decode_image(png)
        jpeg_pixels = decode_image(jpeg)
        jpeg_png = png_bytes(jpeg_pixels)
        jpeg_png_url = "data:image/png;base64," + base64.b64encode(jpeg_png).decode()
        g4_pixels = decode_image(g4)
        pbm_pixels = decode_image(pbm)
        ycc_pixels = decode_image(ycc)
        webp_pixels = decode_image(webp)
        g4_png_url = "data:image/png;base64," + base64.b64encode(png_bytes(g4_pixels)).decode()
        digests = {name: hashlib.sha256(decode_image(raw).tobytes()).hexdigest() == entry["sha256"]
                   for name, (raw, entry) in pages.items()}
        check("files", np.array_equal(decoded, page) and all(digests.values())
              and list(jpeg_pixels.shape) == list(page.shape), files_s=files_s, png_bytes=len(png),
              tokenizer_bytes=os.path.getsize(tok_path), tokenizer_ids=tokenizer.vocab_size,
              in_process_load_s=load_s, png_equals_page=bool(np.array_equal(decoded, page)),
              jpeg_bytes=len(jpeg), jpeg_png_bytes=len(jpeg_png), jpeg_digests_equal=digests)
        prompt = render_prompt("plain", "", PROMPT)

        port = free_port()
        env = dict(os.environ, PYTHONPATH=HERE, DEEPSEEK_OCR_CACHE_DIR=os.path.join(tmp, "cache"),
                   DEEPSEEK_OCR_CONFIG_DIR=os.path.join(tmp, "cfg"))
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            server = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.server", "--config", toml, "--host",
                                       "127.0.0.1", "--port", str(port), "--device", "cuda"],
                                      cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        while True:
            require(server.poll() is None, "frontends: the server exited at start")
            require(time.perf_counter() - t0 < SERVER_START_S, "frontends: the server did not listen in time")
            try:
                if http_call(port, "GET", "/v1/health", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.5)
        start_s = time.perf_counter() - t0

        # the routes' shapes
        health = json.loads(http_call(port, "GET", "/v1/health")[2])
        listing = json.loads(http_call(port, "GET", "/v1/models")[2])
        ids = [m["id"] for m in listing["data"]]
        metrics = http_call(port, "GET", "/metrics")
        check("routes", health == {"status": "ok"} and listing["object"] == "list" and len(ids) == 14
              and {"deepseek-ocr", "deepseek-ocr-q8k"} <= set(ids) and metrics[0] == 200
              and "dsocr_requests_total 0" in metrics[2].splitlines(),
              start_s=start_s, models=len(ids), health=health)

        # parity at the HTTP boundary: the first request loads the model
        t0 = time.perf_counter()
        status, _, text = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr", url,
                                                                                   FRONTEND_MAX_NEW))
        first_s = time.perf_counter() - t0
        reply = json.loads(text)
        from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

        torch.cuda.synchronize()
        K.reset_launches()
        sched = ContinuousScheduler(engine, tokenizer)
        want = asyncio.run(sched.submit(prompt, [decoded], vision, DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        del sched
        usage = {"prompt_tokens": want.prompt_tokens, "completion_tokens": want.response_tokens,
                 "total_tokens": want.prompt_tokens + want.response_tokens}
        got = reply["choices"][0]["message"]["content"] if status == 200 else None
        check("chat_parity", status == 200 and got == want.text and reply["usage"] == usage,
              status=status, seconds_with_load=first_s, usage=reply.get("usage"), in_process_usage=usage,
              text_equal=got == want.text, text_chars=len(want.text),
              launches={k: v for k, v in launches.items() if v})
        for name in required:
            require(launches[name] > 0, f"kernel {name} was not launched in the frontends phase")

        body = {"model": "deepseek-ocr", "stream": True, "max_output_tokens": FRONTEND_MAX_NEW,
                "input": [{"role": "user", "content": [{"type": "input_text", "text": "Free OCR."},
                                                       {"type": "input_image", "image_url": url}]}]}
        status, events, first, total = sse_call(port, "/v1/responses", body)
        kinds = [e if e == "[DONE]" else e.get("type") for e in events]
        joined = "".join(sse_delta(e) for e in events if e != "[DONE]")
        order = (kinds[:1] == ["response.created"] and kinds[-2:] == ["response.completed", "[DONE]"]
                 and set(kinds[1:-2]) <= {"response.output_text.delta"})
        final = events[-2]["response"] if len(events) > 1 and kinds[-2] == "response.completed" else {}
        check("responses_stream", status == 200 and order and normalize_text(joined) == want.text
              and final.get("output", [{}])[0].get("content", [{}])[0].get("text") == want.text,
              status=status, events=len(events), deltas=len(kinds) - 3, first_delta_s=first, seconds=total,
              order=order, deltas_equal_text=normalize_text(joined) == want.text)

        # a concurrent burst: 4 requests and 2 streams at once
        results = [None] * (FRONTEND_BURST + 2)

        def plain(i):
            t = time.perf_counter()
            s, _, txt = http_call(port, "POST", "/v1/chat/completions",
                                  chat_body("deepseek-ocr", url, MAX_NEW))
            results[i] = (s, json.loads(txt).get("usage", {}).get("completion_tokens"), time.perf_counter() - t,
                          None)

        def streamed(i):
            s, evs, first_delta, total_s = sse_call(port, "/v1/chat/completions",
                                                    chat_body("deepseek-ocr", url, MAX_NEW, stream=True))
            usage_ev = [e for e in evs if e != "[DONE]" and e.get("usage")]
            results[i] = (s, usage_ev[-1]["usage"]["completion_tokens"] if usage_ev else None, total_s, first_delta)

        threads = [threading.Thread(target=plain if i < FRONTEND_BURST else streamed, args=(i,))
                   for i in range(FRONTEND_BURST + 2)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(REQUEST_S)
        wall = time.perf_counter() - t0
        done = [r for r in results if r is not None]
        latency = [r[2] for r in done]
        check("burst", len(done) == len(results) and all(r[0] == 200 for r in done)
              and all(r[1] is not None and 0 < r[1] <= MAX_NEW for r in done),
              requests=len(results), answered_200=sum(r[0] == 200 for r in done), wall_s=wall,
              pages_per_s=len(done) / wall, latency_p50_s=statistics.median(latency) if latency else None,
              latency_max_s=max(latency, default=None), first_delta_s=[r[3] for r in done if r[3] is not None],
              completion_tokens=[r[1] for r in done], nvidia_smi=smi_line())

        # the swap to the Q8_0 snapshot
        before = gpu_memory_mib(server.pid)
        t0 = time.perf_counter()
        status, _, text = http_call(port, "POST", "/v1/chat/completions",
                                    chat_body("deepseek-ocr-q8k", url, 16))
        swap_s = time.perf_counter() - t0
        after = gpu_memory_mib(server.pid)
        swaps = [line for line in http_call(port, "GET", "/metrics")[2].splitlines()
                 if line.startswith("dsocr_model_swaps_total ")]
        lower = after[0] < before[0] if before[0] is not None and after[0] is not None else after[1] < before[1]
        check("swap", status == 200 and swaps == ["dsocr_model_swaps_total 2"] and lower, status=status,
              seconds_with_load=swap_s, swaps=swaps, server_mib_before=before[0], server_mib_after=after[0],
              card_mib_before=before[1], card_mib_after=after[1])

        # the JPEG page and the G4 TIFF page on the snapshot, each with the
        # PNG of its pixels, the lossy WebP page and the YCbCr 4:2:0
        # JPEG-in-TIFF page, timed while this server has the card alone;
        # checked below against an in-process scheduler
        t0 = time.perf_counter()
        status_j, _, text_j = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", jpeg_url, FRONTEND_MAX_NEW))
        jpeg_s = time.perf_counter() - t0
        status_p, _, text_p = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", jpeg_png_url, FRONTEND_MAX_NEW))
        t0 = time.perf_counter()
        status_t, _, text_t = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", g4_url, FRONTEND_MAX_NEW))
        tiff_s = time.perf_counter() - t0
        status_tp, _, text_tp = http_call(port, "POST", "/v1/chat/completions",
                                          chat_body("deepseek-ocr-q8k", g4_png_url, FRONTEND_MAX_NEW))
        t0 = time.perf_counter()
        status_w, _, text_w = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", webp_url, FRONTEND_MAX_NEW))
        webp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        status_y, _, text_y = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", ycc_url, FRONTEND_MAX_NEW))
        ycc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        status_n, _, text_n = http_call(port, "POST", "/v1/chat/completions",
                                        chat_body("deepseek-ocr-q8k", pbm_url, FRONTEND_MAX_NEW))
        pbm_s = time.perf_counter() - t0
        reply_j, reply_p, reply_t, reply_tp, reply_w, reply_y, reply_n = (
            json.loads(text) if status == 200 else {} for status, text in (
                (status_j, text_j), (status_p, text_p), (status_t, text_t), (status_tp, text_tp), (status_w, text_w),
                (status_y, text_y), (status_n, text_n)))
        got_j, got_p, got_t, got_tp, got_w, got_y, got_n = (
            r.get("choices", [{}])[0].get("message", {}).get("content")
            for r in (reply_j, reply_p, reply_t, reply_tp, reply_w, reply_y, reply_n))

        # The CLI and (d)'s server under --mesh start here, beside this
        # server's last checks (none of them timed), and are checked after
        # it stops (not before the swap check, which reads the card's
        # memory). The mesh server's first request, which loads its model,
        # goes from a thread.
        out_json = os.path.join(tmp, "out.json")
        cli_log = os.path.join(tmp, "cli.log")
        cli_t0 = time.perf_counter()
        with open(cli_log, "w") as log:
            cli = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.cli", "--config", toml, "--model",
                                    "deepseek-ocr", "--prompt", PROMPT, "--image", os.path.join(tmp, "page.jpg"),
                                    "--max-new-tokens", "32", "--output-json", out_json],
                                   cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        mesh_log = os.path.join(tmp, "server_mesh.log")
        mesh_port = free_port()
        with open(mesh_log, "w") as log:
            mesh_server = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.server", "--config", toml,
                                            "--host", "127.0.0.1", "--port", str(mesh_port), "--device", "cuda",
                                            "--mesh", MESH, "--kv-quant", "int8"],
                                           cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        mesh_out = {}

        def mesh_request():
            try:
                t = time.perf_counter()
                while True:
                    if mesh_server.poll() is not None or time.perf_counter() - t > SERVER_START_S:
                        mesh_out["error"] = "the mesh server exited or did not listen in time"
                        return
                    try:
                        if http_call(mesh_port, "GET", "/v1/health", timeout=5)[0] == 200:
                            break
                    except OSError:
                        time.sleep(0.5)
                mesh_out["start_s"] = time.perf_counter() - t
                t = time.perf_counter()
                mesh_out["reply"] = http_call(mesh_port, "POST", "/v1/chat/completions",
                                              chat_body("deepseek-ocr", url, FRONTEND_MAX_NEW))
                mesh_out["first_s"] = time.perf_counter() - t
                mesh_out["mib"] = gpu_memory_mib(mesh_server.pid)
            except Exception as err:  # reported by the mesh_server check below
                mesh_out["error"] = repr(err)

        mesh_thread = threading.Thread(target=mesh_request, daemon=True)
        mesh_thread.start()

        # the JPEG, G4 TIFF, WebP and JPEG-in-TIFF pages on the snapshot (timed above) against an in-process
        # scheduler
        q8_path = os.path.join(model_dir, "deepseek-ocr-q8k", "snapshot.dsq")
        q8_engine = load_engine(ModelKind.DEEPSEEK, config_path=config, weights_path=index, snapshot_path=q8_path,
                                max_seq_len=8192)
        torch.cuda.synchronize()
        K.reset_launches()
        sched = ContinuousScheduler(q8_engine, tokenizer)
        want_j = asyncio.run(sched.submit(prompt, [jpeg_pixels], vision,
                                          DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
        want_t = asyncio.run(sched.submit(prompt, [g4_pixels], vision,
                                          DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
        want_w = asyncio.run(sched.submit(prompt, [webp_pixels], vision,
                                          DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
        want_y = asyncio.run(sched.submit(prompt, [ycc_pixels], vision,
                                          DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
        torch.cuda.synchronize()
        q8_launches = K.launch_counts()
        launches = {k: launches[k] + q8_launches[k] for k in launches}
        del sched, q8_engine
        gc.collect()
        check("jpeg", status_j == 200 and status_p == 200 and got_j == want_j.text and got_p == got_j
              and reply_j["usage"]["prompt_tokens"] == want_j.prompt_tokens,
              status=status_j, png_status=status_p, seconds=jpeg_s, usage=reply_j.get("usage"),
              in_process_prompt_tokens=want_j.prompt_tokens, text_equal_in_process=got_j == want_j.text,
              text_equal_png=got_p == got_j, text_chars=len(want_j.text))

        usage_t = {"prompt_tokens": want_t.prompt_tokens, "completion_tokens": want_t.response_tokens,
                   "total_tokens": want_t.prompt_tokens + want_t.response_tokens}
        check("tiff", status_t == 200 and status_tp == 200 and got_t == want_t.text and got_tp == got_t
              and reply_t["usage"] == usage_t and reply_tp["usage"] == usage_t,
              status=status_t, png_status=status_tp, seconds=tiff_s, tiff_bytes=len(g4), usage=reply_t.get("usage"),
              in_process_usage=usage_t, text_equal_in_process=got_t == want_t.text,
              text_equal_png=got_tp == got_t, text_chars=len(want_t.text))
        usage_w = {"prompt_tokens": want_w.prompt_tokens, "completion_tokens": want_w.response_tokens,
                   "total_tokens": want_w.prompt_tokens + want_w.response_tokens}
        check("webp", status_w == 200 and got_w == want_w.text and reply_w["usage"] == usage_w,
              status=status_w, seconds=webp_s, webp_bytes=len(webp), usage=reply_w.get("usage"),
              in_process_usage=usage_w, text_equal_in_process=got_w == want_w.text, text_chars=len(want_w.text))
        usage_y = {"prompt_tokens": want_y.prompt_tokens, "completion_tokens": want_y.response_tokens,
                   "total_tokens": want_y.prompt_tokens + want_y.response_tokens}
        check("jpeg_in_tiff", status_y == 200 and got_y == want_y.text and reply_y["usage"] == usage_y,
              status=status_y, seconds=ycc_s, tiff_bytes=len(ycc), usage=reply_y.get("usage"),
              in_process_usage=usage_y, text_equal_in_process=got_y == want_y.text, text_chars=len(want_y.text))
        # the P4 page holds the G4 page's pixels: its answer is the G4 page's
        # PNG's and the in-process scheduler's for those pixels
        pbm_same_pixels = bool(np.array_equal(pbm_pixels, g4_pixels))
        check("pnm", status_n == 200 and pbm_same_pixels and got_n == want_t.text and got_n == got_tp
              and reply_n["usage"] == usage_t,
              status=status_n, seconds=pbm_s, pbm_bytes=len(pbm), pixels_equal_g4=pbm_same_pixels,
              usage=reply_n.get("usage"), text_equal_in_process=got_n == want_t.text, text_equal_png=got_n == got_tp)

        # the error shapes
        unknown = http_call(port, "POST", "/v1/chat/completions", chat_body("bogus", url, 8))
        fallback = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr-q8k", None, 8, text="hi"))
        broken_url = "data:image/jpeg;base64," + base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()
        broken = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr-q8k", broken_url, 8))
        arith = bytearray(jpeg)
        arith[arith.index(b"\xff\xc0") + 1] = 0xC9  # SOF0 → SOF9: arithmetic coding
        arith_url = "data:image/jpeg;base64," + base64.b64encode(bytes(arith)).decode()
        arith_reply = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr-q8k", arith_url, 8))
        thunder = bytearray(g4)  # Compression (SHORT, 1, 4: T.6) → 32809: ThunderScan, refused by name
        at = thunder.index(b"\x03\x01\x03\x00\x01\x00\x00\x00\x04\x00")
        thunder[at + 8:at + 10] = (32809).to_bytes(2, "little")
        ts_url = "data:image/tiff;base64," + base64.b64encode(bytes(thunder)).decode()
        ts_reply = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr-q8k", ts_url, 8))
        big = http_call(port, "POST", "/v1/chat/completions", raw=b"x" * (50 * 2 ** 20 + 1))
        sock = socket.create_connection(("127.0.0.1", port), timeout=REQUEST_S)
        raw = json.dumps(chat_body("deepseek-ocr-q8k", url, FRONTEND_MAX_NEW, stream=True)).encode()
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(raw) + raw)
        got = b""
        while got.count(b"data: ") < 2:  # the role chunk, then the first delta
            piece = sock.recv(1 << 16)
            require(piece, "frontends: the stream ended before its first delta")
            got += piece
        sock.close()
        after_leave = http_call(port, "POST", "/v1/chat/completions", chat_body("deepseek-ocr-q8k", url, 8))
        fallback_text = json.loads(fallback[2])["choices"][0]["message"]["content"] if fallback[0] == 200 else ""
        check("errors", unknown[0] == 400 and fallback[0] == 200 and "Image Required" in fallback_text
              and broken[0] == 400 and "JPEG" in json.loads(broken[2])["error"]["message"]
              and arith_reply[0] == 400
              and "arithmetic-coded JPEG (SOF9)" in json.loads(arith_reply[2])["error"]["message"]
              and ts_reply[0] == 400 and "ThunderScan-compressed TIFF" in json.loads(ts_reply[2])["error"]["message"]
              and big[0] == 413 and after_leave[0] == 200 and server.poll() is None,
              unknown=unknown[0], fallback=fallback[0], jpeg=broken[0], jpeg_message=broken[2][:200],
              arithmetic=arith_reply[0], arithmetic_message=arith_reply[2][:200],
              thunderscan_tiff=ts_reply[0], thunderscan_tiff_message=ts_reply[2][:200],
              over_50mb=big[0], after_client_left=after_leave[0])
        server.send_signal(15)
        server.wait(60)
        check("server_stop", server.returncode == 0, returncode=server.returncode)
        server = None

        # the CLI (started after the swap) against engine.decode in-process
        cli.wait(REQUEST_S)
        cli_s = time.perf_counter() - cli_t0
        if cli.returncode != 0:
            with open(cli_log, errors="replace") as fh:
                print(fh.read()[-8000:], file=sys.stderr)
        result = json.load(open(out_json)) if cli.returncode == 0 else {}
        K.reset_launches()
        mine = engine.decode(tokenizer, prompt, [jpeg_pixels], vision, DecodeParameters(max_new_tokens=32))
        torch.cuda.synchronize()
        decode_launches = K.launch_counts()
        launches = {k: launches[k] + decode_launches[k] for k in launches}
        check("cli", cli.returncode == 0 and result.get("text") == mine.text
              and result.get("generated_tokens") == mine.generated_tokens,
              returncode=cli.returncode, seconds=cli_s, tokens=len(mine.generated_tokens),
              tokens_equal=result.get("generated_tokens") == mine.generated_tokens,
              text_equal=result.get("text") == mine.text)

        # (d) of the mesh phase: the server under --mesh with an int8 KV
        # cache (started after the swap), against the same request on the
        # in-process engine with one
        server, log_path = mesh_server, mesh_log
        mesh_thread.join(SERVER_START_S + REQUEST_S)
        require(not mesh_thread.is_alive() and "error" not in mesh_out,
                f"frontends: the mesh server's request failed: {mesh_out.get('error', 'timed out')}")
        status, _, text = mesh_out["reply"]
        mesh_start_s, mesh_first_s, mesh_mib = mesh_out["start_s"], mesh_out["first_s"], mesh_out["mib"]
        server.send_signal(15)
        server.wait(60)
        stopped = server.returncode
        server = None
        # a second CLI, on the P4 page, once the mesh server has left the
        # card (beside it, or beside the first CLI, it runs out of an 80 GB
        # H100's memory)
        pbm_json, pbm_log = os.path.join(tmp, "out_pbm.json"), os.path.join(tmp, "cli_pbm.log")
        cli_pbm_t0 = time.perf_counter()
        with open(pbm_log, "w") as log:
            cli_pbm = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.cli", "--config", toml, "--model",
                                        "deepseek-ocr", "--prompt", PROMPT, "--image", os.path.join(tmp, "page.pbm"),
                                        "--max-new-tokens", "32", "--output-json", pbm_json],
                                       cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        with open(mesh_log, errors="replace") as fh:
            backend = [line.strip() for line in fh if "mesh of 2 ranks" in line]
        reply = json.loads(text) if status == 200 else {}
        got = reply.get("choices", [{}])[0].get("message", {}).get("content")
        margins = []
        step = engine.slot_step_fn

        def spy(decoder, token_ids, cache, pos):
            logits = step(decoder, token_ids, cache, pos)
            margins.append(top2_margin(torch, logits)[int(cache.lengths.argmax())])
            return logits

        engine.kv_quant, engine.slot_step_fn = "int8", spy
        try:
            sched = ContinuousScheduler(engine, tokenizer)
            want_m = asyncio.run(sched.submit(prompt, [decoded], vision,
                                              DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
            del sched
        finally:
            engine.kv_quant = None
            del engine.slot_step_fn
        same = [t for t in range(len(want_m.generated_tokens) + 1) if got is not None and got.startswith(
            normalize_text(tokenizer.decode(want_m.generated_tokens[:t], skip_special_tokens=True)))]
        first = max(same, default=0)
        # token t came from the packet (t = 0, margin not kept here) or decode step t - 1
        margin = margins[first - 1] if got != want_m.text and 0 < first <= len(margins) else None
        near_tie = margin is not None and margin < MESH_LOGIT_TOL
        least, least_step = mesh_seed_margin(margins)
        check("mesh_server", status == 200 and stopped == 0 and least > MESH_LOGIT_TOL
              and (got == want_m.text or near_tie),
              status=status, mesh=MESH, kv_quant="int8", backend=backend[:1], start_s=mesh_start_s,
              seconds_with_load=mesh_first_s, rank0_mib=mesh_mib[0], card_mib=mesh_mib[1],
              text_equal_single_process=got == want_m.text, text_chars=len(want_m.text),
              first_differing_step=first if got != want_m.text else None, single_process_top2_margin=margin,
              min_top2_margin=least, min_margin_step=least_step + 1, logit_tol=MESH_LOGIT_TOL,
              stopped=stopped)

        # the P4 page's CLI against engine.decode of the same pixels
        cli_pbm.wait(REQUEST_S)
        cli_pbm_s = time.perf_counter() - cli_pbm_t0
        if cli_pbm.returncode != 0:
            with open(pbm_log, errors="replace") as fh:
                print(fh.read()[-8000:], file=sys.stderr)
        result = json.load(open(pbm_json)) if cli_pbm.returncode == 0 else {}
        K.reset_launches()
        mine = engine.decode(tokenizer, prompt, [g4_pixels], vision, DecodeParameters(max_new_tokens=32))
        torch.cuda.synchronize()
        decode_launches = K.launch_counts()
        launches = {k: launches[k] + decode_launches[k] for k in launches}
        check("cli_pnm", cli_pbm.returncode == 0 and result.get("text") == mine.text
              and result.get("generated_tokens") == mine.generated_tokens,
              returncode=cli_pbm.returncode, seconds=cli_pbm_s, tokens=len(mine.generated_tokens),
              tokens_equal=result.get("generated_tokens") == mine.generated_tokens,
              text_equal=result.get("text") == mine.text)
        del engine
    finally:
        for proc in (server, cli, cli_pbm, mesh_server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(60)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "frontends", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line()})
    return launches


FAMILY_REQUESTS = 4  # the families' bursts: 4 pages over 4 slots (8 before the DotsOCR/GLM-OCR phase)
FAMILY_MAX_NEW = 32  # 64 before the mesh_dense phase
PADDLE_IMAGE_SIZE = 0  # no clamp: the seeded page smart-resizes to max_pixels (94 × 152 patches)
PADDLE_IMAGE_END_ID = 101305  # a stand-in <|IMAGE_END|> id beside the config's vision-start 101304
FAMILY_ATTENTION = ["flash_prefill_attention", "slot_kv_write", "slot_decode_attention"]


class PaddleBenchTokenizer(BenchTokenizer):
    """BenchTokenizer with PaddleOCR-VL's <|IMAGE_END|>."""

    def token_to_id(self, token):
        return PADDLE_IMAGE_END_ID if token == "<|IMAGE_END|>" else super().token_to_id(token)


def ocr2_config():
    """DeepSeek-OCR2 at the published widths: the DeepSeek-V2 decoder of
    OCR1, SAM ViT-B whose last conv gives the Qwen2 encoder's 896
    channels, the linear projector from 896."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig
    from dsocr_tpu_torch.models.deepseek.config import SamParams

    return dataclasses.replace(DeepseekOcrConfig(), variant="ocr2", clip=None, sam=SamParams(out_channels=(512, 896)),
                               projector_input_dim=896)


def sentencepiece_tokenizer(path, vocab_size, specials, seed=0, max_len=12):
    """Write a tokenizer.json of a SentencePiece-converted BPE (PaddleOCR-VL's
    ERNIE shape): the 256 byte tokens <0xNN> for byte fallback, ▁ and the
    printable ASCII, seeded random merges filling every id below
    `vocab_size` that `specials` ({id: content}) leaves free (id 0 is
    <unk>), the special tokens as added tokens, a Metaspace pre-tokenizer
    (prepend_scheme first) and ByteFallback + Metaspace + Fuse decoders."""
    import random

    rng = random.Random(seed)
    specials = {0: "<unk>", **specials}
    base = ["▁"] + [chr(c) for c in range(33, 127)]
    tokens, seen, merges = list(base), set(base) | set(specials.values()), []
    while len(tokens) < vocab_size - len(specials) - 256:
        a = tokens[rng.randrange(len(tokens))]
        b = tokens[rng.randrange(len(base) if rng.random() < 0.75 else len(tokens))]
        if len(a) + len(b) <= max_len and a + b not in seen:
            seen.add(a + b)
            tokens.append(a + b)
            merges.append([a, b])
    tokens = [f"<0x{b:02X}>" for b in range(256)] + tokens
    ids = [i for i in range(vocab_size) if i not in specials]
    vocab = dict(zip(tokens, ids))
    vocab.update({content: i for i, content in specials.items()})
    metaspace = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True} for i, c in sorted(specials.items())],
        "normalizer": None, "pre_tokenizer": metaspace, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [{"type": "ByteFallback"}, metaspace, {"type": "Fuse"}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    return path


def family_burst(torch, K, phase, engine, tokenizer, image, vision, *, required, n_requests=FAMILY_REQUESTS,
                 max_new=FAMILY_MAX_NEW, extra=None, max_len=4096):
    """n_requests copies of `image` through ContinuousScheduler over as many
    slots (max_len-position rows, 128-step chunks), after a warm-up of one
    request × 8 tokens on the same slots (the engine's first serving: its
    caches and allocator pools, not measured); the launch counters zeroed
    just before and read just after, every kernel in `required` must
    launch. → (launch counts, tokens)."""
    from dsocr_tpu_torch.core import DecodeParameters

    serve(engine, tokenizer, [image], vision, DecodeParameters(max_new_tokens=8), n_slots=n_requests,
          max_len=max_len, chunk=CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with recording() as rec:
        t0 = time.perf_counter()
        outs, sched = serve(engine, tokenizer, [image] * n_requests, vision, DecodeParameters(max_new_tokens=max_new),
                            n_slots=n_requests, max_len=max_len, chunk=CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()
    generated = [o.generated_tokens for o in outs]
    line = {"phase": phase, "quantize": engine.quantize, "kv_quant": engine.kv_quant, "requests": len(outs),
            "slots": n_requests, "prompt_tokens": outs[0].prompt_tokens if outs else None,
            "tokens_per_request": [len(g) for g in generated], "wall_s": wall, "pages_per_s": len(outs) / wall,
            "decode_tok_per_s": sum(map(len, generated)) / wall,
            "ttft_p50_s": statistics.median(sched.ttft_samples),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "stage_ms": rec.stage_totals() if rec is not None else None,
            "launches": {k: v for k, v in launches.items() if v}, "nvidia_smi": smi_line(), **(extra or {})}
    emit(line)
    require(len(outs) == n_requests and all(generated), f"{phase}: a request returned no tokens")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the {phase} burst")
    return launches, generated


def family_profile(torch, phase, engine, pre, max_len, *, mrope=False, qkv=False):
    """Where the time goes in a family's burst, at its shape: a prefill
    wave of FAMILY_REQUESTS rows of the page's prompt (`pre`, its length
    padded to 128; seeded embeddings, positions 0..S−1 on every axis)
    through the decoder, host ms around the synchronized call (median of 3
    after a warm-up) and device ms under torch.profiler; then decode steps
    on FAMILY_REQUESTS slots of max_len positions joined with `pre`, rows
    that never end: host ms a step (median of 3 windows of 8 steps), and
    device ms, busy share and kernel events a step under torch.profiler
    over 4 steps; peak device GiB. With `qkv` (GLM), layer 0's q/k/v
    product at the step's rows and at the wave's, as served (the weight
    held in f32) and with the weight in bf16 cast to f32 at every call:
    device ms of each."""
    from dsocr_tpu_torch.core import DecodeParameters

    t0 = time.perf_counter()
    dec = engine.model.decoder
    rows, n_prompt = FAMILY_REQUESTS, len(pre["prompt_ids"])
    S = -(-n_prompt // 128) * 128
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = (torch.randn((rows, S, dec.cfg.hidden_size), generator=gen, device="cuda") * 0.02).to(engine.dtype)
    positions = torch.arange(S, device="cuda")[None].expand(rows, S)
    if mrope:
        positions = positions[None].expand(3, rows, S)
    last = torch.full((rows,), n_prompt - 1, device="cuda")

    def wave():
        with torch.no_grad():
            dec.prefill(embeds, positions, last_index=last)

    wave()
    line = {"phase": phase, "quantize": engine.quantize, "rows": rows, "prompt_tokens": n_prompt,
            "wave_positions": S, "prefill_wave_ms": statistics.median(synced_ms(torch, wave, 1) for _ in range(3))}
    line["prefill_device_ms"], _, line["prefill_top"] = traced(torch, wave, 1)
    del embeds
    runner, cache = engine.make_slot_runner(), engine.new_slot_cache(rows, max_len)
    runner.eos_ids = ()
    state = runner.init_state(cache, max_len)
    runner.join_many(state, list(range(rows)), [pre] * rows, [DecodeParameters()] * rows, [max_len - S] * rows,
                     [None] * rows)
    chunk = lambda n: runner.run_chunk(dec, state, n)  # noqa: E731
    chunk(4)
    windows = [synced_ms(torch, lambda: chunk(8), 8) for _ in range(3)]
    line["decode_step_ms"], line["decode_step_ms_windows"] = statistics.median(windows), windows
    events = []
    line["step_device_ms"], traced_ms, line["step_top"] = traced(torch, lambda: chunk(4), 4, events)
    line["step_busy_share"] = line["step_device_ms"] / traced_ms
    line["step_launches"] = sum(e.count for e in events) / 4  # kernel events a step
    if qkv:
        w32 = dec.layers[0].qkv_proj
        w16 = w32.to(engine.dtype)
        for name, n in (("step", rows), ("wave", rows * S)):
            x = torch.randn((n, dec.cfg.hidden_size), generator=gen, device="cuda").to(engine.dtype).float()
            line[f"qkv_{name}_held_f32_ms"] = time_ms(lambda: torch.matmul(x, w32))
            line[f"qkv_{name}_cast_each_call_ms"] = time_ms(lambda: torch.matmul(x, w16.float()))
            del x
    line.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, seconds=time.perf_counter() - t0,
                nvidia_smi=smi_line())
    emit(line)
    require(line["prefill_device_ms"] > 0 and line["step_device_ms"] > 0, f"{phase}: the profiler saw no device time")


def ocr2_prefill_logits(engine, image, vision):
    """The page through an OCR2 engine's towers and one-row prefill → logits."""
    vin = engine.prepare_vision_input(image, vision)
    emb = engine.compute_image_embedding(vin)
    tokens, mask = engine.build_prompt_tokens(BenchTokenizer(), PROMPT, [vin], [emb], vision)
    return engine._prefill_rows([(tokens, mask, [emb])])[0]["logits"]


def families_phase(torch, K, smi):
    """DeepSeek-OCR2 and PaddleOCR-VL on the card (the module docstring's
    `families` phase). → the in-process runs' launch counts."""
    import shutil

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.core.engine import ModelKind
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, DeepseekOcrEngine
    from dsocr_tpu_torch.models.paddleocr import PaddleConfig, PaddleOcrEngine
    from dsocr_tpu_torch.models.registry import load_engine

    t_phase = time.perf_counter()
    root = os.path.join(WEIGHTS_DIR, "families")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    require(free >= WEIGHTS_DISK, f"{free} bytes free in {root}; the families phase needs {WEIGHTS_DISK}")
    page, _ = seeded_page()
    ocr2_vision = VisionSettings(1024, 768, True)
    paddle_vision = VisionSettings(1024, PADDLE_IMAGE_SIZE, False)
    bursts = []
    kw = dict(dtype="bfloat16", max_seq_len=4096, kv_quant="int8", device="cuda")

    def free_engines():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        # 1. OCR2 at full width, seeded, through load_engine on its config.json
        cfg = ocr2_config()
        os.makedirs(os.path.join(root, "ocr2_seeded"))
        seeded_config = os.path.join(root, "ocr2_seeded", "config.json")
        with open(seeded_config, "w") as fh:
            json.dump(config_json(cfg), fh)
        require(DeepseekOcrConfig.from_json(seeded_config) == cfg, "families: the OCR2 config.json does not round-trip")
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.DEEPSEEK, config_path=seeded_config, **kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        vin = engine.prepare_vision_input(page, ocr2_vision)
        groups = [engine._pixels(vin.patches), engine._pixels(vin.global_pixels)]
        sams = [engine.model.sam(g) for g in groups]
        vision = {"init_s": init_s, "tiles": len(vin.patches), "crop_shape": vin.crop_shape,
                  "sam_ms_per_page": sum(time_ms(lambda g=g: engine.model.sam(g), reps=2, batches=2)
                                         for g in groups),
                  "encoder_ms_per_page": sum(time_ms(lambda f=f: engine.model.ocr2(f), reps=2, batches=2)
                                             for f in sams),
                  "image_tokens": int(engine.compute_image_embedding(vin).shape[0])}
        del groups, sams
        launches, _ = family_burst(torch, K, "families_ocr2", engine, BenchTokenizer(), page, ocr2_vision,
                                   required=["sam_flash_attention"] + FAMILY_ATTENTION, extra=vision)
        bursts.append(launches)
        del engine
        free_engines()

        # 2. OCR2 from files: the language depth cut to 2 layers (dense, MoE)
        # with a router bias; SAM and the encoder at full depth
        cfg2 = dataclasses.replace(cfg, language=dataclasses.replace(cfg.language, num_hidden_layers=2))
        seeded = DeepseekOcrEngine(cfg2, dtype=torch.bfloat16, device="cuda", max_seq_len=4096, seed=0,
                                   kv_quant="int8")
        state = dict(seeded.model.state_dict())
        del seeded
        gen = torch.Generator(device="cuda").manual_seed(5)
        state["decoder.moe_layers.0.gate_bias"] = (torch.randn(cfg2.language.n_routed_experts, generator=gen,
                                                               device="cuda") * 0.5).to(torch.bfloat16)
        ocr2_dir = os.path.join(root, "ocr2")
        os.makedirs(ocr2_dir)
        t0 = time.perf_counter()
        ocr2_index, ocr2_config_path, written = write_checkpoint(torch, state, cfg2, ocr2_dir)
        write_s = time.perf_counter() - t0
        biased = DeepseekOcrEngine(cfg2, dtype=torch.bfloat16, device="cuda", max_seq_len=4096, kv_quant="int8",
                                   state=state)
        del state
        want = ocr2_prefill_logits(biased, page, ocr2_vision)
        del biased
        free_engines()
        t0 = time.perf_counter()
        loaded = load_engine(ModelKind.DEEPSEEK, config_path=ocr2_config_path, weights_path=ocr2_index, **kw)
        load_s = time.perf_counter() - t0
        got = ocr2_prefill_logits(loaded, page, ocr2_vision)
        has_bias = hasattr(loaded.model.decoder.moe_layers[0], "gate_bias")
        del loaded
        free_engines()
        q8 = os.path.join(ocr2_dir, "q8_0.dsq")
        export_s = export_snapshot(torch, ocr2_index, ocr2_config_path, q8, "q8_0")
        snap = load_engine(ModelKind.DEEPSEEK, config_path=ocr2_config_path, weights_path=ocr2_index,
                           snapshot_path=q8, **kw)
        K.reset_launches()
        outs, _ = serve(snap, BenchTokenizer(), [page], ocr2_vision, DecodeParameters(max_new_tokens=FAMILY_MAX_NEW),
                        n_slots=1, max_len=4096, chunk=CHUNK)
        torch.cuda.synchronize()
        snap_launches = K.launch_counts()
        bursts.append(snap_launches)
        line = {"phase": "families_ocr2_files", "layers": 2, "checkpoint_bytes": written, "write_s": write_s,
                "load_s": load_s, "router_bias_loaded": has_bias, "prefill_logits_equal": bool(torch.equal(got, want)),
                "logits_finite": bool(torch.isfinite(got).all()), "q8_export_s": export_s,
                "q8_snapshot_bytes": os.path.getsize(q8), "q8_quantize": snap.quantize,
                "q8_tokens": len(outs[0].generated_tokens),
                "q8_launches": {k: v for k, v in snap_launches.items() if v}}
        emit(line)
        require(has_bias and line["prefill_logits_equal"], "families: OCR2 from files differs from the seeded engine")
        require(snap.quantize == "q8_0" and outs[0].generated_tokens, "families: the OCR2 snapshot served nothing")
        for name in ("q8_matmul", "q8_gather_matmul", "slot_decode_attention"):
            require(snap_launches[name] > 0, f"kernel {name} was not launched by the OCR2 snapshot")
        del snap, got, want
        os.remove(q8)
        free_engines()

        # 3. PaddleOCR-VL at full width from files, held to the seeded state
        # with its tower cast to f32 (what the loader makes of the bf16 file)
        pcfg = PaddleConfig()
        seeded = PaddleOcrEngine(pcfg, dtype=torch.bfloat16, device="cuda", max_seq_len=4096, seed=0,
                                 kv_quant="int8")
        state = dict(seeded.model.state_dict())
        del seeded
        paddle_dir = os.path.join(root, "paddle")
        os.makedirs(paddle_dir)
        t0 = time.perf_counter()
        paddle_index, paddle_config_path, pwritten = write_checkpoint(torch, state, pcfg, paddle_dir)
        write_s = time.perf_counter() - t0
        require(PaddleConfig.from_json(paddle_config_path) == pcfg, "families: the Paddle config.json does not round-trip")
        seeded = PaddleOcrEngine(pcfg, dtype=torch.bfloat16, device="cuda", max_seq_len=4096, kv_quant="int8",
                                 state={k: v.float() if k.startswith("vision.") else v for k, v in state.items()})
        del state
        params = DecodeParameters(max_new_tokens=16)
        want = seeded.decode(PaddleBenchTokenizer(), PROMPT, [page], paddle_vision, params).generated_tokens
        del seeded
        free_engines()
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.PADDLE_OCR_VL, config_path=paddle_config_path, weights_path=paddle_index, **kw)
        load_s = time.perf_counter() - t0
        got = engine.decode(PaddleBenchTokenizer(), PROMPT, [page], paddle_vision, params).generated_tokens
        patches = engine.preprocess(page, paddle_vision)
        group = engine._encode_group([patches])
        siglip_ms = time_ms(lambda: engine._encode_group([patches]), reps=1, batches=1)
        emit({"phase": "families_paddle_files", "checkpoint_bytes": pwritten, "write_s": write_s, "load_s": load_s,
              "tokens_equal": got == want, "tokens": got, "grid_thw": patches.grid_thw,
              "patches": int(patches.patches.shape[0]), "image_tokens": int(group.shape[1]),
              "siglip_and_projector_ms_per_page": siglip_ms, "vision_dtype": str(engine.model.vision.patch_embed.w.dtype)})
        require(got == want, "families: the Paddle file engine's tokens differ from the seeded engine's")
        del group
        launches, _ = family_burst(torch, K, "families_paddle", engine, PaddleBenchTokenizer(), page, paddle_vision,
                                   required=FAMILY_ATTENTION, extra={"grid_thw": patches.grid_thw,
                                                                     "patches": int(patches.patches.shape[0]),
                                                                     "siglip_and_projector_ms_per_page": siglip_ms})
        bursts.append(launches)
        del engine
        free_engines()
        q8 = os.path.join(paddle_dir, "q8_0.dsq")
        export_s = export_snapshot(torch, paddle_index, paddle_config_path, q8, "q8_0")
        engine = load_engine(ModelKind.PADDLE_OCR_VL, config_path=paddle_config_path, weights_path=paddle_index,
                             snapshot_path=q8, **kw)
        require(engine.quantize == "q8_0", "families: the Paddle snapshot did not serve packed")
        launches, _ = family_burst(torch, K, "families_paddle_q8", engine, PaddleBenchTokenizer(), page,
                                   paddle_vision, required=FAMILY_ATTENTION + ["q8_matmul"],
                                   extra={"q8_export_s": export_s, "q8_snapshot_bytes": os.path.getsize(q8)})
        bursts.append(launches)
        del engine
        os.remove(q8)
        free_engines()
        dense_mesh_reference(torch, "e")  # mesh_dense's case (e) on one process

        # 4. both families through the server and the CLI
        lang = cfg2.language
        bursts.append(family_frontends(torch, K, root, "families_frontends", {
            "deepseek-ocr-2": FrontendModel(
                ModelKind.DEEPSEEK, ocr2_index, ocr2_config_path,
                lambda path: synthetic_tokenizer(path, lang.vocab_size, {
                    lang.bos_token_id: "<｜begin▁of▁sentence｜>", lang.eos_token_id: "<｜end▁of▁sentence｜>",
                    IMAGE_TOKEN_ID: "<image>"}),
                VisionSettings(1024, 768, True), False),
            "paddleocr-vl": FrontendModel(
                ModelKind.PADDLE_OCR_VL, paddle_index, paddle_config_path,
                lambda path: sentencepiece_tokenizer(path, pcfg.vocab_size, {
                    pcfg.bos_token_id: "<s>", pcfg.eos_token_id: "</s>",
                    pcfg.image_token_id: "<|IMAGE_PLACEHOLDER|>", pcfg.vision_start_token_id: "<|IMAGE_START|>",
                    PADDLE_IMAGE_END_ID: "<|IMAGE_END|>"}),
                VisionSettings(1024, 640, True), True)}, page))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_engines()
    emit({"phase": "families", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return {name: sum(b[name] for b in bursts) for name in bursts[0]}


FAMILIES2_TOKENS = 16  # the files cases' greedy tokens through engine.decode
GLM_SLOT_SEQ = 8192  # a GLM page's ~6,160-token prompt and its new tokens
FRONTEND_SLOT_SEQ = GLM_SLOT_SEQ  # the front ends' slot rows (past the default 4096 for GLM)
DOTS_SPECIALS = {151643: "<|endoftext|>", 151652: "<|img|>", 151653: "<|endofimg|>", 151665: "<|imgpad|>"}
GLM_SPECIALS = {59246: "<|endoftext|>", 59248: "[gMASK]", 59250: "<sop>", 59253: "<|user|>", 59254: "<|assistant|>",
                59255: "<|observation|>", 59256: "<|begin_of_image|>", 59257: "<|image|>", 59258: "<|end_of_image|>",
                59259: "<|begin_of_video|>", 59260: "<|end_of_video|>"}


def round_tower_(torch, engine):
    """Round the engine's f32 tower weights to bf16 values in place: what
    a published bf16 checkpoint holds and the loader reads back in f32, so
    a file engine holds the same values."""
    with torch.no_grad():
        for p in engine.model.vision.parameters():
            p.copy_(p.to(torch.bfloat16).float())


def file_state(torch, engine):
    """The engine's state_dict in bf16, as it is written: the tower and
    GLM's q/k/v, which the engine holds in f32, too."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in engine.model.state_dict().items()}


def families2_phase(torch, K, smi):
    """DotsOCR and GLM-OCR on the card at the published widths, on the
    seeded page (the module docstring's `families2` phase). → the
    in-process runs' launch counts."""
    import shutil

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.core.engine import ModelKind
    from dsocr_tpu_torch.models.dots import DotsConfig
    from dsocr_tpu_torch.models.glm import GlmConfig
    from dsocr_tpu_torch.models.glm.engine import preprocess_glm_image_raw
    from dsocr_tpu_torch.models.registry import load_engine
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

    t_phase = time.perf_counter()
    root = os.path.join(WEIGHTS_DIR, "families2")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    require(free >= WEIGHTS_DISK, f"{free} bytes free in {root}; the families2 phase needs {WEIGHTS_DISK}")
    dots_cfg, glm_cfg = DotsConfig(), GlmConfig()
    page = seeded_page()[0]
    vision = VisionSettings(1024, 0, False)  # no clamp: the page smart-resizes to the pixel budget
    kw = dict(dtype="bfloat16", max_seq_len=GLM_SLOT_SEQ, kv_quant="int8", device="cuda")
    tok = BenchTokenizer()
    params = DecodeParameters(max_new_tokens=FAMILIES2_TOKENS)
    bursts = []

    def free_engines():
        gc.collect()
        torch.cuda.empty_cache()

    def towers(encode):
        """(tower ms a page: device time of one encode of the page, after
        one untimed; its merged tokens)."""
        merged = encode()
        return time_ms(encode, reps=1, batches=1), int(merged.shape[0])

    def decoded(engine):
        return engine.decode(tok, PROMPT, [page], vision, params).generated_tokens

    try:
        # 1. DotsOCR at full width, seeded, through load_engine on its config.json
        dots_dir = os.path.join(root, "dots")
        os.makedirs(dots_dir)
        config = os.path.join(dots_dir, "config.json")
        with open(config, "w") as fh:
            json.dump(dots_config_json(dots_cfg), fh)
        require(DotsConfig.from_json(config) == dots_cfg, "families2: the Dots config.json does not round-trip")
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.DOTS_OCR, config_path=config, **kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        round_tower_(torch, engine)
        tower_ms, tokens = towers(lambda: engine.encode_images([page], vision)[0][0])
        grid = engine._prep(vision)
        launches, _ = family_burst(torch, K, "families2_dots", engine, tok, page, vision, required=FAMILY_ATTENTION,
                                   extra={"init_s": init_s, "tower_ms_per_page": tower_ms, "image_tokens": tokens,
                                          "max_pixels": grid.max_pixels})
        bursts.append(launches)
        family_profile(torch, "families2_dots_profile", engine, engine.prefill_for_slot(tok, PROMPT, [page], vision),
                       4096)
        want = decoded(engine)
        t0 = time.perf_counter()
        dots_index, _, written = write_checkpoint(torch, file_state(torch, engine), dots_cfg, dots_dir)
        write_s = time.perf_counter() - t0
        del engine
        free_engines()
        engine = load_engine(ModelKind.DOTS_OCR, config_path=config, quantize="q8_0", **kw)
        round_tower_(torch, engine)
        launches, _ = family_burst(torch, K, "families2_dots_q8", engine, tok, page, vision,
                                   required=FAMILY_ATTENTION + ["q8_matmul"])
        bursts.append(launches)
        family_profile(torch, "families2_dots_q8_profile", engine,
                       engine.prefill_for_slot(tok, PROMPT, [page], vision), 4096)
        want_q8 = decoded(engine)
        mesh_reference(torch, engine, "f", *MESH_DENSE_BURST, page=dense_case_page(engine, "dots"))
        del engine
        free_engines()

        # 2. DotsOCR from files: the checkpoint, then its Q8_0 snapshot
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.DOTS_OCR, config_path=config, weights_path=dots_index, **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        K.reset_launches()
        got = decoded(engine)
        bursts.append(K.launch_counts())
        del engine
        free_engines()
        q8 = os.path.join(dots_dir, "q8_0.dsq")
        export_s = export_snapshot(torch, dots_index, config, q8, "q8_0")
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.DOTS_OCR, config_path=config, weights_path=dots_index, snapshot_path=q8, **kw)
        torch.cuda.synchronize()
        snap_load_s = time.perf_counter() - t0
        K.reset_launches()
        got_q8 = decoded(engine)
        snap_launches = K.launch_counts()
        bursts.append(snap_launches)
        line = {"phase": "families2_dots_files", "checkpoint_bytes": written, "write_s": write_s, "load_s": load_s,
                "tokens_equal": got == want, "tokens": got, "q8_export_s": export_s,
                "q8_snapshot_bytes": os.path.getsize(q8), "q8_load_s": snap_load_s, "q8_quantize": engine.quantize,
                "q8_tokens_equal": got_q8 == want_q8, "q8_tokens": got_q8, "nvidia_smi": smi}
        emit(line)
        require(got == want, "families2: the Dots file engine's tokens differ from the seeded engine's")
        require(engine.quantize == "q8_0" and got_q8 == want_q8,
                "families2: the Dots Q8_0 snapshot's tokens differ from the seeded Q8_0 engine's")
        require(snap_launches["q8_matmul"] > 0, "families2: q8_matmul did not launch for the Dots snapshot")
        del engine
        os.remove(q8)
        free_engines()

        # 3. GLM-OCR at full width, seeded, through load_engine on its config.json
        glm_dir = os.path.join(root, "glm")
        os.makedirs(glm_dir)
        glm_config = os.path.join(glm_dir, "config.json")
        with open(glm_config, "w") as fh:
            json.dump(glm_config_json(glm_cfg), fh)
        with open(os.path.join(glm_dir, "preprocessor_config.json"), "w") as fh:
            json.dump(glm_preprocessor_json(glm_cfg), fh)
        require(GlmConfig.from_json(glm_config) == glm_cfg, "families2: the GLM config.json does not round-trip")
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.GLM_OCR, config_path=glm_config, **kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        round_tower_(torch, engine)
        tower_ms, tokens = towers(lambda: engine.encode_images([page])[0])
        launches, _ = family_burst(torch, K, "families2_glm", engine, tok, page, vision, required=FAMILY_ATTENTION,
                                   max_len=GLM_SLOT_SEQ,
                                   extra={"init_s": init_s, "tower_ms_per_page": tower_ms, "image_tokens": tokens,
                                          "grid_thw": preprocess_glm_image_raw(page, glm_cfg)[1]})
        bursts.append(launches)
        family_profile(torch, "families2_glm_profile", engine, engine.prefill_for_slot(tok, PROMPT, [page], vision),
                       GLM_SLOT_SEQ, mrope=True, qkv=True)
        want = decoded(engine)
        sched = ContinuousScheduler(engine, tok, n_slots=2, max_len=GLM_SLOT_SEQ)
        refused = None
        try:
            asyncio.run(sched.submit(PROMPT, [page], vision, DecodeParameters(max_new_tokens=4, do_sample=True,
                                                                               temperature=0.7)))
        except ValueError as err:
            refused = str(err)
        emit({"phase": "families2_glm_sampled", "refused": refused})
        require(refused is not None and "greedy" in refused, "families2: a sampled GLM request was not refused")
        t0 = time.perf_counter()
        glm_index, _, written = write_checkpoint(torch, file_state(torch, engine), glm_cfg, glm_dir)
        write_s = time.perf_counter() - t0
        del engine, sched
        free_engines()

        # 4. GLM-OCR from files
        t0 = time.perf_counter()
        engine = load_engine(ModelKind.GLM_OCR, config_path=glm_config, weights_path=glm_index, **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        K.reset_launches()
        got = decoded(engine)
        bursts.append(K.launch_counts())
        emit({"phase": "families2_glm_files", "checkpoint_bytes": written, "write_s": write_s, "load_s": load_s,
              "tokens_equal": got == want, "tokens": got, "nvidia_smi": smi})
        require(got == want, "families2: the GLM file engine's tokens differ from the seeded engine's")
        del engine
        free_engines()
        dense_mesh_reference(torch, "g")  # mesh_dense's case (g) on one process

        # 5. both families through the server and the CLI
        bursts.append(family_frontends(torch, K, root, "families2_frontends", {
            "dots-ocr": FrontendModel(ModelKind.DOTS_OCR, dots_index, config,
                                      lambda path: synthetic_tokenizer(path, dots_cfg.text.vocab_size, DOTS_SPECIALS),
                                      VisionSettings(1024, 640, False), True),
            "glm-ocr": FrontendModel(ModelKind.GLM_OCR, glm_index, glm_config,
                                     lambda path: synthetic_tokenizer(path, glm_cfg.text.vocab_size, GLM_SPECIALS),
                                     VisionSettings(336, 336, False), True)}, page, mesh_model=MESH_SERVER_MODEL))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_engines()
    emit({"phase": "families2", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return {name: sum(b[name] for b in bursts) for name in bursts[0]}


class FrontendModel(NamedTuple):
    """One model id of family_frontends: its kind, checkpoint index and
    config.json, a writer of its tokenizer.json (path → path), its
    vision settings, and whether the CLI runs it too."""

    kind: Any
    index: str
    config: str
    tokenizer: Callable[[str], str]
    vision: Any
    cli: bool


def family_frontends(torch, K, root, phase, models, page, mesh_model=None):
    """The server with a config.toml naming `models` ({id: FrontendModel},
    files written by the calling phase) with their synthetic
    tokenizer.jsons and vision defaults, slot rows of FRONTEND_SLOT_SEQ
    positions: one greedy chat request to each id in order (each after the
    first a swap), its text and usage equal to the in-process scheduler's
    over load_engine of the same files, model_swaps_total counting the
    loads; then, for `mesh_model`, a second server under ``--mesh MESH``
    answering a chat request of MESH_SERVER_TEXT for MESH_SERVER_NEW tokens
    with the in-process (single-process) text and usage, every top-2
    margin of that in-process answer's steps above MESH_LOGIT_TOL;
    then the CLI on each id with `cli` set against engine.decode of
    the in-process engine its chat check loaded. The CLI runs start in
    their own processes beside the server, before its first request, so
    their seconds overlap it. → launch counts of the in-process runs."""
    import base64

    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.core.text import render_prompt
    from dsocr_tpu_torch.image.decode import decode_image
    from dsocr_tpu_torch.models.registry import load_engine
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler
    from dsocr_tpu_torch.utils.tokenizer import load_tokenizer

    tmp = os.path.join(root, "frontends")
    os.makedirs(tmp)
    log_path = os.path.join(tmp, "server.log")
    server = None
    t_phase = time.perf_counter()

    def check(name, ok, **fields):
        emit({"phase": phase, "check": name, "ok": bool(ok), **fields})
        if not ok and server is not None:
            with open(log_path, errors="replace") as fh:
                print(fh.read()[-20000:], file=sys.stderr)
        require(ok, f"{phase}: {name} failed: {fields}")

    t0 = time.perf_counter()
    toks = {model: m.tokenizer(os.path.join(tmp, f"{model}_tokenizer.json")) for model, m in models.items()}
    png = write_png(os.path.join(tmp, "page.png"), page)
    url = "data:image/png;base64," + base64.b64encode(png).decode()
    toml = os.path.join(tmp, "config.toml")
    with open(toml, "w") as fh:
        fh.write(f'[models]\nactive = "{next(iter(models))}"\n\n[inference]\ndevice = "cuda"\n')
        for model, m in models.items():
            v = m.vision
            fh.write(f'\n[models.entries."{model}"]\nconfig = "{m.config}"\ntokenizer = "{toks[model]}"\n'
                     f'weights = "{m.index}"\n\n[models.entries."{model}".defaults]\nbase_size = {v.base_size}\n'
                     f'image_size = {v.image_size}\ncrop_mode = {str(v.crop_mode).lower()}\n')
    files_s = time.perf_counter() - t0
    decoded = decode_image(png)
    prompt = render_prompt("plain", "", PROMPT)
    env = dict(os.environ, PYTHONPATH=HERE, DEEPSEEK_OCR_CACHE_DIR=os.path.join(tmp, "cache"),
               DEEPSEEK_OCR_CONFIG_DIR=os.path.join(tmp, "cfg"), DSOCR_SLOT_SEQ=str(FRONTEND_SLOT_SEQ))
    port = free_port()
    launches = {}
    clis = {}  # model → (the CLI's process, its output json, its log, its start)
    kept = {}  # model → the in-process (engine, tokenizer) its CLI run is held against

    def in_process(model):
        m = models[model]
        return (load_engine(m.kind, config_path=m.config, weights_path=m.index, max_seq_len=FRONTEND_SLOT_SEQ,
                            device="cuda"), load_tokenizer(toks[model]))

    try:
        for model in (model for model, m in models.items() if m.cli):
            out_json, cli_log = os.path.join(tmp, f"{model}.json"), os.path.join(tmp, f"{model}_cli.log")
            with open(cli_log, "w") as log:
                clis[model] = (subprocess.Popen(
                    [sys.executable, "-m", "dsocr_tpu_torch.cli", "--config", toml, "--model", model, "--prompt",
                     PROMPT, "--image", os.path.join(tmp, "page.png"), "--max-new-tokens", "32", "--output-json",
                     out_json, "--device", "cuda"], cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT),
                    out_json, cli_log, time.perf_counter())
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            server = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.server", "--config", toml, "--host",
                                       "127.0.0.1", "--port", str(port), "--device", "cuda"],
                                      cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        while True:
            require(server.poll() is None, f"{phase}: the server exited at start")
            require(time.perf_counter() - t0 < SERVER_START_S, f"{phase}: the server did not listen")
            try:
                if http_call(port, "GET", "/v1/health", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.5)
        check("start", True, start_s=time.perf_counter() - t0, files_s=files_s,
              tokenizer_bytes={m: os.path.getsize(p) for m, p in toks.items()})
        for i, model in enumerate(models):
            t0 = time.perf_counter()
            status, _, text = http_call(port, "POST", "/v1/chat/completions", chat_body(model, url, FRONTEND_MAX_NEW))
            server_s = time.perf_counter() - t0
            reply = json.loads(text)
            engine, tokenizer = in_process(model)
            torch.cuda.synchronize()
            K.reset_launches()
            want = asyncio.run(ContinuousScheduler(engine, tokenizer, max_len=FRONTEND_SLOT_SEQ).submit(
                prompt, [decoded], models[model].vision, DecodeParameters(max_new_tokens=FRONTEND_MAX_NEW)))
            torch.cuda.synchronize()
            got_launches = K.launch_counts()
            launches = {k: launches.get(k, 0) + v for k, v in got_launches.items()}
            usage = {"prompt_tokens": want.prompt_tokens, "completion_tokens": want.response_tokens,
                     "total_tokens": want.prompt_tokens + want.response_tokens}
            got = reply["choices"][0]["message"]["content"] if status == 200 else None
            swaps = [line for line in http_call(port, "GET", "/metrics")[2].splitlines()
                     if line.startswith("dsocr_model_swaps_total ")]
            check(f"chat_{model}", status == 200 and got == want.text and reply["usage"] == usage
                  and reply.get("model") == model and swaps == [f"dsocr_model_swaps_total {i + 1}"],
                  status=status, error=None if status == 200 else text[:500], seconds_with_load=server_s,
                  usage=reply.get("usage"), in_process_usage=usage, text_equal=got == want.text,
                  text_chars=len(want.text), swaps=swaps, launches={k: v for k, v in got_launches.items() if v})
            for name in FAMILY_ATTENTION:
                require(got_launches[name] > 0, f"kernel {name} was not launched for {model} in-process")
            if model in clis or model == mesh_model:
                kept[model] = (engine, tokenizer)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        server.send_signal(15)
        server.wait(60)
        check("server_stop", server.returncode == 0, returncode=server.returncode)
        server = None
        if mesh_model is not None:  # (h) of the mesh_dense phase: the server under --mesh
            # its request on the in-process engine, each step's top-2 margin kept
            engine, tokenizer = kept[mesh_model]
            margins, step = [], engine.slot_step_fn

            def spy(decoder, token_ids, cache, pos):
                logits = step(decoder, token_ids, cache, pos)
                margins.append(top2_margin(torch, logits)[int(cache.lengths.argmax())])
                return logits

            engine.slot_step_fn = spy
            try:
                want_m = asyncio.run(ContinuousScheduler(engine, tokenizer, max_len=FRONTEND_SLOT_SEQ).submit(
                    render_prompt("plain", "", "<image>\n" + MESH_SERVER_TEXT), [decoded], models[mesh_model].vision,
                    DecodeParameters(max_new_tokens=MESH_SERVER_NEW)))
            finally:
                del engine.slot_step_fn
            del engine
            if mesh_model not in clis:
                kept.pop(mesh_model)
            log_path = os.path.join(tmp, "server_mesh.log")
            mesh_port = free_port()
            t0 = time.perf_counter()
            with open(log_path, "w") as log:
                server = subprocess.Popen([sys.executable, "-m", "dsocr_tpu_torch.server", "--config", toml, "--host",
                                           "127.0.0.1", "--port", str(mesh_port), "--device", "cuda", "--mesh", MESH],
                                          cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
            while True:
                require(server.poll() is None, f"{phase}: the mesh server exited at start")
                require(time.perf_counter() - t0 < SERVER_START_S, f"{phase}: the mesh server did not listen")
                try:
                    if http_call(mesh_port, "GET", "/v1/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    time.sleep(0.5)
            start_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            status, _, text = http_call(mesh_port, "POST", "/v1/chat/completions",
                                        chat_body(mesh_model, url, MESH_SERVER_NEW, text=MESH_SERVER_TEXT))
            mesh_s = time.perf_counter() - t0
            mesh_mib = gpu_memory_mib(server.pid)
            server.send_signal(15)
            server.wait(60)
            stopped = server.returncode
            server = None
            reply = json.loads(text) if status == 200 else {}
            got = reply.get("choices", [{}])[0].get("message", {}).get("content")
            least, least_step = mesh_seed_margin(margins)
            usage = {"prompt_tokens": want_m.prompt_tokens, "completion_tokens": want_m.response_tokens,
                     "total_tokens": want_m.prompt_tokens + want_m.response_tokens}
            check("mesh_server", status == 200 and stopped == 0 and got == want_m.text
                  and reply.get("usage") == usage and least > MESH_LOGIT_TOL, model=mesh_model, status=status,
                  mesh=MESH, error=None if status == 200 else text[:500], start_s=start_s, seconds_with_load=mesh_s,
                  rank0_mib=mesh_mib[0], card_mib=mesh_mib[1], text_equal_single_process=got == want_m.text,
                  usage=reply.get("usage"), in_process_usage=usage, min_top2_margin=least,
                  min_margin_step=least_step + 1, logit_tol=MESH_LOGIT_TOL, stopped=stopped)
        for model, (cli, out_json, cli_log, started) in clis.items():
            returncode = cli.wait(REQUEST_S)
            cli_s = time.perf_counter() - started
            if returncode != 0:
                with open(cli_log, errors="replace") as fh:
                    print(fh.read()[-8000:], file=sys.stderr)
            result = json.load(open(out_json)) if returncode == 0 else {}
            engine, tokenizer = kept.pop(model)
            K.reset_launches()
            mine = engine.decode(tokenizer, prompt, [decoded], models[model].vision,
                                 DecodeParameters(max_new_tokens=32))
            torch.cuda.synchronize()
            launches = {k: launches[k] + v for k, v in K.launch_counts().items()}
            check(f"cli_{model}", returncode == 0 and result.get("generated_tokens") == mine.generated_tokens
                  and result.get("text") == mine.text, returncode=returncode, seconds=cli_s,
                  tokens=len(mine.generated_tokens),
                  tokens_equal=result.get("generated_tokens") == mine.generated_tokens)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for proc in [server] + [cli for cli, *_ in clis.values()]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(60)
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line()})
    return launches


def split_phase(torch, K, engine, steps=16):
    """The decoder's split layout at full width on the card: the bf16 split
    tree of phase 4's engine (fusing it gives the engine's weights) over a
    contiguous KVCache, prefill of the page's packet (the grouped MoE tier)
    and `steps` greedy steps (the single tier), fed the fused engine's
    tokens so that each step's logits compare; then moe_apply with
    gather_threshold=N for N in (2, 4, 16) at layer 1's experts through
    gather_matmul, held to the same call on the CPU. Tolerances: logits
    bit-equal and tokens equal (both layouts run the same column products
    through the same kernels; every run on the H100 read 0.0); moe_apply
    2^-6 of its largest output (f32 sums in another order can move an inter
    element's bf16 rounding, then the output's, by one ulp)."""
    from dsocr_tpu_torch.models.deepseek.decoder import DeepseekDecoder
    from dsocr_tpu_torch.ops import moe
    from dsocr_tpu_torch.runtime.kv_cache import bump_length

    lang = engine.cfg.language
    fused = engine.model.decoder
    t0 = time.perf_counter()
    split = DeepseekDecoder.from_state(lang, split_state(torch, fused.state_dict(), lang),
                                       engine.dtype, engine.device)
    require(split.moe_layers[0].split, "the split state built a fused decoder")
    build_s = time.perf_counter() - t0
    _, _, tokens, mask, emb = page_packet(engine)
    s_pad = -(-len(tokens) // 128) * 128
    embeds = engine._embeds_rows([(tokens, mask, [emb])], s_pad)
    lens = torch.tensor([len(tokens)], device="cuda")

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = {}
    for name, dec in (("fused", fused), ("split", split)):
        with torch.no_grad():
            logits, cache = dec(embeds, torch.arange(s_pad, device="cuda")[None],
                                engine.new_kv_cache(1, s_pad + steps + 8), engine._rope,
                                last_index=lens - 1, flash_prefill=True)
        runs[name] = (logits, bump_length(cache, len(tokens)))
    fed, errs, split_tokens, fused_tokens = None, [], [], []
    scale = float(runs["fused"][0].abs().max())
    for step in range(steps + 1):
        (lf, cf), (ls, cs) = runs["fused"], runs["split"]
        errs.append(float((lf - ls).abs().max()))
        scale = max(scale, float(lf.abs().max()))
        fed = lf.argmax(dim=-1)
        fused_tokens.append(int(fed))
        split_tokens.append(int(ls.argmax(dim=-1)))
        if step == steps:
            break
        with torch.no_grad():
            runs = {"fused": engine._step_fn(fused, fed, cf, None)[:2],
                    "split": engine._step_fn(split, fed, cs, None)[:2]}
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = K.launch_counts()
    differ = [[i, a, b] for i, (a, b) in enumerate(zip(fused_tokens, split_tokens)) if a != b]
    line = {"phase": "split", "prompt_tokens": len(tokens), "steps": steps, "build_s": build_s,
            "forward_s": forward_s, "max_abs_logit_err": max(errs), "max_abs_logit": scale,
            "tokens_equal": not differ, "differing_tokens": differ,
            "flash_prefill_launches": launches["flash_prefill_attention"]}
    del runs, embeds

    layer = split.moe_layers[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    cpu_stacks = [w.cpu() for w in (layer.experts_gate, layer.experts_up, layer.experts_down)]
    checks = []
    K.reset_launches()
    for n in (2, 4, 16):
        x = (torch.randn((n, lang.hidden_size), generator=gen, device="cuda")).to(engine.dtype)
        weights, idx = moe.moe_router(x, layer.gate_weight, split.moe_cfg)
        out = moe.moe_apply(x, weights, idx, layer.experts_gate, layer.experts_up, layer.experts_down,
                            gather_threshold=n)
        ref = moe.moe_apply(x.cpu(), weights.cpu(), idx.cpu(), *cpu_stacks, gather_threshold=n)
        err = float((out.float().cpu() - ref.float()).abs().max())
        tol = float(ref.float().abs().max()) * 2.0 ** -6
        checks.append({"n": n, "max_abs_err": err, "tol": tol})
        require(err <= tol, f"moe_apply(gather_threshold={n}): max abs err {err} > tol {tol}")
    gather_launches = K.launch_counts()
    line.update(moe_apply_gather=checks, gather_matmul_launches=gather_launches["gather_matmul"])
    emit(line)
    require(line["max_abs_logit_err"] == 0.0,
            f"split vs fused logits differ by up to {line['max_abs_logit_err']}")
    require(not differ, f"split vs fused greedy tokens differ at [step, fused, split] {differ}")
    require(gather_launches["gather_matmul"] > 0, "moe_apply's gather tier did not launch gather_matmul")
    del split, cpu_stacks
    gc.collect()
    torch.cuda.empty_cache()
    return gather_launches


# the gather tier's traces, short for the smoke's time: the decode phase's
# traced steps, and the new tokens of the burst that gather_trace runs again
GATHER_STEPS = 8
DECODE_NEW = 128  # the decode phases' new tokens
DEBUG_LOGITS_STEP = 5  # the decode step whose top-2 logits the bf16 decode phase's dump call dumps
DEBUG_DECODE_NEW = 8  # that call's new tokens
GATHER_TRACE_NEW = 8


def is_gather_kernel(name: str) -> bool:
    """A profiler kernel name of the gather tier: csrc/expert_sweep.cu's
    gather instantiations, whose last template argument is true, or the
    expert_kernel of trees before it (serve_ab.py reads a parent's)."""
    return ("sweep_kernel<" in name and name.split(">")[0].endswith("true")) or "::expert_kernel<" in name


def decode_phase(torch, K, engine, smi, required, max_new=DECODE_NEW, debug_dumps=False):
    """Single-request decode at full width: engine.decode on the seeded page,
    max_new greedy tokens (after a warm-up prefill and 4 steps of the same
    path), the launch counters zeroed just before and read just after;
    every kernel in `required` must have launched. With packed weights,
    GATHER_STEPS more warm-up steps under torch.profiler give the gather tier's
    device ms a token beside the step's (`gather`). `debug_dumps` then
    runs one more, uncounted and untimed engine.decode under the
    reference's debug knobs and checks its dumps (debug_dumps_check)."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.runtime.kv_cache import bump_length

    image, vision, tokens, mask, emb = page_packet(engine)
    s_pad = -(-len(tokens) // 128) * 128
    with torch.no_grad():
        logits, cache = engine._prefill(engine._embeds_rows([(tokens, mask, [emb])], s_pad),
                                        engine.new_kv_cache(1, s_pad + 8 + GATHER_STEPS),
                                        torch.tensor([len(tokens)], device="cuda"))
        cache = bump_length(cache, len(tokens))
        for _ in range(4):
            logits, cache, _ = engine._step_fn(engine.model.decoder, logits.argmax(dim=-1), cache, None)
        gather = None
        if engine.quantize:  # the gather tier's device ms a token, from GATHER_STEPS traced steps
            state = [logits, cache]

            def steps():
                for _ in range(GATHER_STEPS):
                    state[0], state[1], _ = engine._step_fn(engine.model.decoder, state[0].argmax(dim=-1),
                                                            state[1], None)

            kernels = []
            step_ms, host_ms, _ = traced(torch, steps, GATHER_STEPS, kernels)
            mine = [e for e in kernels if is_gather_kernel(e.key)]
            gather = {"steps": GATHER_STEPS, "device_ms_per_token": sum(map(device_us, mine)) / 1e3 / GATHER_STEPS,
                      "launches_per_token": sum(e.count for e in mine) / GATHER_STEPS,
                      "step_device_ms": step_ms, "step_host_ms_traced": host_ms}
            logits, cache = state
    del logits, cache, emb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = engine.decode(BenchTokenizer(), PROMPT, [image], vision, DecodeParameters(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = engine.decode_stages
    eos = engine.cfg.language.eos_token_id
    line = {"phase": "decode", "quantize": engine.quantize, "nvidia_smi": smi,
            "prompt_tokens": out.prompt_tokens, "response_tokens": out.response_tokens,
            "truncated": out.truncated, "wall_s": wall, "stages_s": st,
            "prefill_s": st["decode.prefill"],
            "decode_ms_per_step": st["decode.generate"] * 1e3 / max(st["decode.steps"], 1),
            "decode_tok_per_s": out.response_tokens / st["decode.generate"],
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v for k, v in launches.items() if v}}
    if gather is not None:
        line["gather"] = gather
    emit(line)
    require(out.response_tokens == max_new or (eos not in out.generated_tokens and not out.truncated),
            f"decode returned {out.response_tokens} of {max_new} tokens without EOS")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the decode phase")
    if debug_dumps:
        debug_dumps_check(engine, image, vision)
    return launches


def debug_dumps_check(engine, image, vision):
    """One engine.decode of DEBUG_DECODE_NEW tokens on the page under the
    reference's debug knobs (DSOCR_DEBUG_VISION_PATH, DSOCR_DEBUG_LOGITS_STEP
    = DEBUG_LOGITS_STEP, DSOCR_DEBUG_LOGITS_PATH), after the decode phase's
    counted and timed call: the vision dump's stage names and shapes are
    the reference's for the page's global view (sam, clip, fusion,
    projector), its stats finite; the logits dump is step
    DEBUG_LOGITS_STEP's, its `chosen` the token decode generated there,
    its margin >= 0."""
    import math
    import shutil
    import tempfile

    from dsocr_tpu_torch.core import DecodeParameters

    cfg = engine.cfg
    directory = tempfile.mkdtemp(prefix="debug-dumps-")
    try:
        with environ(DSOCR_DEBUG_VISION_PATH=os.path.join(directory, "vision.json"),
                     DSOCR_DEBUG_LOGITS_STEP=str(DEBUG_LOGITS_STEP),
                     DSOCR_DEBUG_LOGITS_PATH=os.path.join(directory, "logits.json")):
            out = engine.decode(BenchTokenizer(), PROMPT, [image], vision,
                                DecodeParameters(max_new_tokens=DEBUG_DECODE_NEW))
        with open(os.path.join(directory, "vision.json")) as fh:
            trace = json.load(fh)
        with open(os.path.join(directory, "logits.json")) as fh:
            logits = json.load(fh)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    # the global view's grid: SAM's 16-pixel patches, then two stride-2 convs
    g = (vision.base_size if vision.crop_mode else vision.image_size) // 64
    want = [("sam", [1, cfg.sam.out_channels[1], g, g]), ("clip", [1, g * g + 1, cfg.clip.hidden_size]),
            ("fusion", [1, g * g, cfg.projector_input_dim]), ("projector", [1, g * g, cfg.projector_n_embed])]
    stages = [(st["stage"], st["shape"]) for st in trace["stages"]]
    finite = all(math.isfinite(st[k]) for st in trace["stages"] for k in ("mean", "std", "min", "max"))
    step = logits.get("step")
    chosen_ok = step == DEBUG_LOGITS_STEP and step < len(out.generated_tokens) \
        and logits.get("chosen") == out.generated_tokens[step]
    line = {"phase": "debug_dumps", "stages": trace["stages"], "logits": logits,
            "stages_equal_reference": stages == want, "stats_finite": finite, "chosen_equals_generated": chosen_ok}
    emit(line)
    require(stages == want and finite, f"the vision dump's stages {stages} are not the reference's {want}")
    require(chosen_ok and logits.get("margin", -1.0) >= 0.0,
            f"the logits dump {logits} does not name step {DEBUG_LOGITS_STEP}'s generated token")


def towers_f32_phase(torch, K, engine, smi):
    """DSOCR_VISION_F32's towers against the engine's bf16 ones on the same
    weights: f32 copies of this engine's SAM and CLIP (no second model;
    the projector stays bf16, as under the knob) swapped in for one
    measurement. For the seeded page's towers (its global view and tiles,
    engine._compute_image_embeddings_batched) in each dtype: device ms
    (the kernel events of one call under torch.profiler) and host ms
    around the synchronized call (median of 3 after a warm-up); the card's
    used MiB with both copies resident, and the largest |difference| of
    the global view's projector output. The f32 towers must reach
    sam_flash_attention."""
    import copy

    vin = page_input(engine)

    def towers():
        engine._compute_image_embeddings_batched([vin])

    def measure():
        towers()
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            towers()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        device_ms, _, top = traced(torch, towers, 1)
        return device_ms, statistics.median(host), top

    t_phase = time.perf_counter()
    with torch.no_grad():
        bf16_ms, bf16_host, bf16_top = measure()
        want = engine._tower(vin.global_pixels).float()
        sam, clip = engine.model.sam, engine.model.clip
        sam32, clip32 = copy.deepcopy(sam).float(), copy.deepcopy(clip).float()
        try:
            engine.model.sam, engine.model.clip = sam32, clip32
            f32_ms, f32_host, f32_top = measure()
            K.reset_launches()
            got = engine._tower(vin.global_pixels).float()
            torch.cuda.synchronize()
            launches = K.launch_counts()["sam_flash_attention"]
            used = gpu_memory_mib(os.getpid())
            tower_mib = sum(t.numel() * t.element_size() for m in (sam32, clip32) for t in m.parameters()) / 2 ** 20
        finally:
            engine.model.sam, engine.model.clip = sam, clip
    diff = float((got - want).abs().max())
    line = {"phase": "towers_f32", "nvidia_smi": smi, "views": 1 + (len(vin.patches) if vin.patches is not None else 0),
            "bf16_device_ms": bf16_ms, "f32_device_ms": f32_ms, "f32_over_bf16": f32_ms / bf16_ms,
            "bf16_host_ms": bf16_host, "f32_host_ms": f32_host, "bf16_top": bf16_top, "f32_top": f32_top,
            "process_used_mib": used[0], "card_used_mib": used[1], "f32_tower_weights_mib": tower_mib,
            "projector_max_abs_diff": diff, "projector_max_abs": float(want.abs().max()),
            "f32_sam_attention_launches": launches, "seconds": time.perf_counter() - t_phase}
    del sam32, clip32, got, want
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    require(math.isfinite(diff) and launches > 0,
            f"the f32 towers: projector difference {diff}, {launches} sam_flash_attention launches")


def serve(engine, tokenizer, images, vision, params, *, n_slots, max_len, chunk):
    """One request per image, all submitted at once; (outcomes, scheduler)."""
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(engine, tokenizer, n_slots=n_slots, max_len=max_len,
                                chunk_steps=chunk, prefill_batch=n_slots)

    async def run():
        return await asyncio.gather(*(sched.submit(PROMPT, [img], vision, params) for img in images))

    return asyncio.run(run()), sched


@contextlib.contextmanager
def recording():
    """A BenchRecorder installed for the block → the recorder (None from a
    tree without core/benchmark.py, which serve_ab.py may drive)."""
    try:
        from dsocr_tpu_torch.core.benchmark import BenchRecorder, set_recorder
    except ImportError:
        yield None
        return
    rec = BenchRecorder()
    set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(None)


def serving_phase(torch, K, phase, engine, *, n_requests, n_slots, max_new, required,
                  warmup=True, profile=False, towers=False, unused=(), same_as=None, trace_gather=False,
                  chunk=CHUNK, speculate=False):
    """Phases 4-4h: n_requests requests of max_new tokens through
    ContinuousScheduler over n_slots at its defaults (speculative chunk
    dispatch on), chunks of `chunk` steps; the launch counters are zeroed
    just before and read just after, every kernel in `required` must have
    launched and none in `unused`. The line gives the scheduler's
    speculated_chunks and stage_ms, the stage totals of a BenchRecorder
    installed for the burst (while one is installed, the engine waits for
    the towers and the prefill to finish inside their stages); with
    `speculate`, speculated_chunks must be > 0. A paged burst also
    reports its pool and, against `same_as` (another burst's tokens), how
    many requests gave the same tokens. With `profile`, profile_phase
    follows on the page's packet (with `towers`, its tower line too); with
    `trace_gather`, gather_trace on the burst's requests. → (launch counts,
    tokens per request)."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.runtime.paged import PagedSlotCache

    image, vision, tokens, mask, emb = page_packet(engine)
    params = DecodeParameters(max_new_tokens=max_new)  # greedy, no-repeat-ngram 20
    tok = BenchTokenizer()
    s_pad = -(-len(tokens) // 128) * 128
    max_len = min(engine.max_seq_len, -(-(s_pad + max_new) // 512) * 512)
    if warmup:  # cuBLAS/cuDNN handles, allocator pools; not measured
        serve(engine, tok, [image] * 2, vision, DecodeParameters(max_new_tokens=8),
              n_slots=n_slots, max_len=max_len, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with recording() as rec:
        t0 = time.perf_counter()
        outs, sched = serve(engine, tok, [image] * n_requests, vision, params,
                            n_slots=n_slots, max_len=max_len, chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()

    generated = [o.generated_tokens for o in outs]
    n_tokens = sum(len(g) for g in generated)
    eos = engine.cfg.language.eos_token_id
    line = {
        "phase": phase, "quantize": engine.quantize, "requests": len(outs), "slots": n_slots,
        "prompt_tokens": len(tokens), "max_len": max_len,
        "tokens_per_request": [len(g) for g in generated], "wall_s": wall,
        "pages_per_s": len(outs) / wall, "decode_tok_per_s": n_tokens / wall,
        "ttft_p50_s": statistics.median(sched.ttft_samples),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "occupancy_per_chunk": sched.batch_sizes, "chunk": chunk,
        "speculated_chunks": getattr(sched, "speculated_chunks", None),
        "stage_ms": rec.stage_totals() if rec is not None else None, "launches": launches,
    }
    cache = sched._state.cache
    if isinstance(cache, PagedSlotCache):
        lang = engine.cfg.language
        per_token = lang.num_hidden_layers * lang.resolved_kv_heads * (
            (lang.head_dim + lang.resolved_v_head_dim) * cache.k.element_size()
            + (8 if cache.k_scale is not None else 0))
        pages_per_row = -(-max(s_pad, len(tokens) + max_new) // cache.page_size)
        line.update(pool_pages=cache.n_pages, page_size=cache.page_size,
                    pool_bytes=nbytes(cache.k, cache.v, cache.k_scale, cache.v_scale),
                    contiguous_cache_bytes=n_slots * max_len * per_token,
                    rows_the_pool_holds=cache.n_pages // pages_per_row,
                    max_occupancy=max(sched.batch_sizes),
                    pages_free_after=sched._runner.allocator.free_count)
        require(line["max_occupancy"] <= line["rows_the_pool_holds"], "more rows than the pool holds")
        require(line["pages_free_after"] == cache.n_pages, "pages were not returned")
    if same_as is not None:
        line["requests_equal_to_contiguous_burst"] = sum(a == b for a, b in zip(generated, same_as))
    # one more prefill of the page's packet (the join packet that
    # prefill_for_slot makes, outside the window) to read the logits of the path
    pre = engine._prefill_rows([(tokens, mask, [emb])])[0]
    del emb
    line["logits_finite"] = bool(torch.isfinite(pre["logits"]).all())
    emit(line)
    require(len(outs) == n_requests, "not every request completed")
    for g, o in zip(generated, outs):
        # a row stops at its budget, or earlier only on EOS (never appended)
        require(len(g) == max_new or (len(g) < max_new and not o.truncated and eos not in g),
                f"a request returned {len(g)} of {max_new} tokens without EOS")
    require(line["logits_finite"], "non-finite logits")
    require(not speculate or line["speculated_chunks"], f"the {phase} burst speculated no chunk")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the {phase} burst")
    for name in unused:
        require(launches[name] == 0, f"kernel {name} was launched in the {phase} burst")
    if profile:
        profile_phase(torch, K, engine, pre, paged=isinstance(cache, PagedSlotCache), towers=towers)
    if trace_gather:
        gather_trace(torch, K, phase, engine, lambda: serve(
            engine, tok, [image] * n_requests, vision, DecodeParameters(max_new_tokens=min(max_new, GATHER_TRACE_NEW)),
            n_slots=n_slots, max_len=max_len, chunk=CHUNK))
    return launches, generated


def gather_trace(torch, K, phase, engine, burst):
    """The gather tier in a burst: `burst` (the burst's requests at
    GATHER_TRACE_NEW tokens) once more under torch.profiler,
    every gather wrapper's idx kept (a copy on the card). Emits the tier's
    device ms and launches (per decode step: two a MoE layer), and for
    each selection count its launches and their distinct in-range experts
    (min, mean, max) beside the mean of as many uniform draws."""
    E = engine.cfg.language.n_routed_experts
    names = {f"{fmt}_gather_matmul" for fmt in ("q8", "q4k", "q6k")}
    kept = []

    def keep(w):
        def kept_idx(*args, **kwargs):
            kept.append(args[-1].clone())
            return w(*args, **kwargs)

        return kept_idx

    kernels = []
    with wrapped_kernels(K, keep, names):
        traced(torch, burst, 1, kernels)
    mine = [e for e in kernels if is_gather_kernel(e.key)]
    launches = sum(e.count for e in mine)
    device_ms = sum(map(device_us, mine)) / 1e3
    by_count = {}
    for idx in kept:
        by_count.setdefault(idx.numel(), []).append(torch.unique(idx[(idx >= 0) & (idx < E)]).numel())
    per_step = 2 * len(engine.model.decoder.moe_layers)
    emit({"phase": f"{phase}_trace", "gather_launches": launches, "wrapper_calls": len(kept),
          "gather_device_ms": device_ms, "device_ms_per_launch": device_ms / max(launches, 1),
          "device_ms_per_step": device_ms * per_step / max(launches, 1), "launches_per_step": per_step,
          "distinct_experts": {s: {"launches": len(d), "min": min(d), "mean": statistics.fmean(d), "max": max(d),
                                   "uniform_mean": E * (1 - (1 - 1 / E) ** s)}
                               for s, d in sorted(by_count.items())}})
    require(launches > 0 and kept, f"{phase}: the trace saw no gather launch")


@contextlib.contextmanager
def wrapped_kernels(K, wrap, names=None):
    """Within the block, every kernel wrapper (or those named in `names`)
    is wrap(wrapper) where the port calls it. The kernel modules keep their
    own names, through which they count launches."""
    patched = []
    wrappers = {w.__name__: w for w, _, _ in K.KERNELS if names is None or w.__name__ in names}
    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "")
        if not name.startswith("dsocr_tpu_torch.") or name.startswith("dsocr_tpu_torch.ops.kernels."):
            continue
        for attr, w in wrappers.items():
            if getattr(mod, attr, None) is w:
                setattr(mod, attr, wrap(w))
                patched.append((mod, attr, w))
    try:
        yield
    finally:
        for mod, attr, w in patched:
            setattr(mod, attr, w)


def wrapper_host_ms(K, fn) -> float:
    """Run fn with every kernel wrapper timed on the host clock where the
    port calls it; → milliseconds spent inside the wrappers (checks, the
    output's allocation, the ctypes launch)."""
    spent = []

    def timer(w):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = w(*args, **kwargs)
            spent.append(time.perf_counter() - t0)
            return out

        return timed

    with wrapped_kernels(K, timer):
        fn()
    return sum(spent) * 1e3


def synced_ms(torch, fn, n_calls: int) -> float:
    """Host ms per call of fn, synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_calls


def traced(torch, fn, n_calls: int, kernels_out=None):
    """fn once under torch.profiler → (device ms per call: the kernel
    events' durations; host ms per call of the traced window, which the
    profiler slows; the 4 largest kernels [name, launches, ms] per call).
    The kernel events are appended to `kernels_out` where it is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if kernels_out is not None:
        kernels_out.extend(kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:4]
    return (sum(map(device_us, kernels)) / 1e3 / n_calls, wall * 1e3 / n_calls,
            [[e.key[:60], e.count / n_calls, device_us(e) / 1e3 / n_calls] for e in top])


# the SAM global-attention kernels' names: its own bodies
# (sam_attention_*_kernel), and before them the flash_tile body it shared
# with the f32 decoder prefill (which the towers never launch), so the
# tower line also reads a parent tree
SAM_KERNEL_NAMES = ("sam_attention_", "flash_tile_kernel")


def tower_profile(torch, K, engine, pages=TOWER_PAGES):
    """The vision towers of a TOWER_PAGES-page burst: the seeded page's VisionInput
    (page_input, so no host prep in the window) `pages` times through
    engine._compute_image_embeddings_batched, which pools the pages' views
    as the scheduler's prefill does (4 global views and 16 tiles a call).
    Host ms around the synchronized call (median of 3 after a warm-up),
    then one call under torch.profiler: the towers' device ms, the SAM
    global attention's device ms, launches and share of it, the largest
    kernels."""
    vins = [page_input(engine)] * pages

    def towers():
        engine._compute_image_embeddings_batched(vins)

    t0 = time.perf_counter()
    towers()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        towers()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    K.reset_launches()
    events = []
    device_ms, traced_ms, top = traced(torch, towers, 1, kernels_out=events)
    sam_ms = sum(device_us(e) for e in events if any(n in e.key for n in SAM_KERNEL_NAMES)) / 1e3
    line = {"phase": "profile_towers", "pages": pages, "host_ms": statistics.median(host),
            "host_ms_runs": host, "device_ms": device_ms, "busy_share": device_ms / traced_ms,
            "sam_attention_ms": sam_ms, "sam_attention_share": sam_ms / device_ms,
            "sam_attention_launches": K.launch_counts()["sam_flash_attention"], "top": top,
            "seconds": time.perf_counter() - t0}
    emit(line)
    require(device_ms > 0 and sam_ms > 0, "the profiler saw no tower or SAM attention time")
    return line


def profile_phase(torch, K, engine, pre, paged=False, towers=False):
    """Where the time goes at 16 rows in the engine's weight format:
    a prefill wave (16 rows × 1024 seeded embeddings through the decoder,
    host clock around synchronized work, median of 3 after a warm-up) and
    decode steps (the page's packet joined into 16 slots that never end,
    SlotRunner.run_chunk, or with `paged` a PagedSlotRunner over a pool
    of 16 × 12 pages, greedy with the 20-gram ban: host ms per step,
    median of 4 windows of 16 steps). Then one wave and 4 steps under
    torch.profiler (device ms, busy share, kernel launches a step: the
    kernel events' count, largest kernels), and 16 steps
    with every kernel wrapper timed on the host: the host ms per step
    inside the wrappers against the rest of the step. `seconds` gives the
    wall seconds of each part. With `towers`, tower_profile's line
    follows."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.ops.rope import build_rope_tables
    from dsocr_tpu_torch.runtime.slots import SlotRunner

    dec = engine.model.decoder
    lang = engine.cfg.language
    rows, window = PROFILE_ROWS, PROFILE_WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rope = build_rope_tables(engine.max_seq_len, lang.rope_dim, lang.rope_theta, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = (torch.randn((rows, PROFILE_WAVE, lang.hidden_size), generator=gen, device="cuda")
              * 0.02).to(engine.dtype)
    positions = torch.arange(PROFILE_WAVE, device="cuda")[None].expand(rows, PROFILE_WAVE)
    last = torch.full((rows,), PROFILE_WAVE - 1, device="cuda")

    def wave():
        with torch.no_grad():
            dec.prefill(embeds, positions, rope, last_index=last)

    t0 = time.perf_counter()
    wave()
    line = {"phase": "profile", "quantize": engine.quantize, "paged": paged,
            "prefill_wave_ms": statistics.median(synced_ms(torch, wave, 1) for _ in range(3))}
    t1 = time.perf_counter()
    line["prefill_device_ms"], _, line["prefill_top"] = traced(torch, wave, 1)
    seconds = {"waves": t1 - t0, "traced_wave": time.perf_counter() - t1}
    del embeds

    context = 1536  # the 904-token prompt and every step below
    if paged:
        runner, cache = engine.make_paged_slot_runner(rows, context, n_pages=rows * context // 128)
        runner.eos_ids = ()
    else:
        runner, cache = SlotRunner(engine.slot_step_fn, eos_ids=()), engine.new_slot_cache(rows, context)
    t0 = time.perf_counter()
    state = runner.init_state(cache, context)
    budget = context - len(pre["prompt_ids"])  # more than the steps below take
    runner.join_many(state, list(range(rows)), [pre] * rows, [DecodeParameters()] * rows,
                     [budget] * rows, [None] * rows)
    chunk = lambda n: runner.run_chunk(dec, state, n)  # noqa: E731
    chunk(8)
    windows = [synced_ms(torch, lambda: chunk(window), window) for _ in range(4)]
    line["decode_step_ms"], line["decode_step_ms_windows"] = statistics.median(windows), windows
    t1 = time.perf_counter()
    step_events = []
    line["step_device_ms"], traced_ms, line["step_top"] = traced(torch, lambda: chunk(4), 4, step_events)
    line["step_busy_share"] = line["step_device_ms"] / traced_ms
    line["step_launches"] = sum(e.count for e in step_events) / 4  # kernel events a step
    seconds.update(join_and_steps=t1 - t0, traced_steps=time.perf_counter() - t1)
    t1 = time.perf_counter()
    K.reset_launches()
    spent = []
    step_ms = synced_ms(torch, lambda: spent.append(wrapper_host_ms(K, lambda: chunk(window))), window)
    line["wrapper_calls_per_step"] = sum(K.launch_counts().values()) / window
    line["wrapper_host_ms_per_step"] = spent[0] / window
    line["rest_host_ms_per_step"] = step_ms - spent[0] / window
    line["seconds"] = {**seconds, "wrapper_steps": time.perf_counter() - t1}
    line["expert_bytes_per_dense_step"] = sum(
        sum(t.numel() * t.element_size() for t in (w.buffers() if isinstance(w, torch.nn.Module) else [w]))
        for layer in dec.moe_layers for w in (layer.experts_gateup, layer.experts_down))
    line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(line)
    require(all(t > 0 for t in (line["prefill_device_ms"], line["step_device_ms"])),
            "the profiler saw no device time")
    if towers:
        tower_profile(torch, K, engine)


def profile_packet(torch, K, engine, paged=False):
    """profile_phase on the seeded page's packet, without a burst before it
    (serve_ab.py --profiles)."""
    _, _, tokens, mask, emb = page_packet(engine)
    pre = engine._prefill_rows([(tokens, mask, [emb])])[0]
    del emb
    profile_phase(torch, K, engine, pre, paged=paged)


def full_width_engine(torch, quantize=None):
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, DeepseekOcrEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = DeepseekOcrEngine(DeepseekOcrConfig(), dtype=torch.bfloat16, device="cuda",
                               max_seq_len=4096, seed=0, kv_quant="int8", quantize=quantize)
    torch.cuda.synchronize()
    emit({"phase": "init", "quantize": quantize, "init_s": time.perf_counter() - t0,
          "quantize_s": engine.model.decoder.quantize_s,
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return engine


def files_parity(torch, cfg, directory, device=None):
    """Phase 5's files: FILES_PARITY_SEED's f32 engine of `cfg` written
    as a checkpoint in `directory`, exported as a Q4_K and a Q6_K snapshot
    (quantized on `device`, the card by default) → (index, {method: path})."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine

    os.makedirs(directory, exist_ok=True)
    seeded = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=FILES_PARITY_SEED)
    index, config, _ = write_checkpoint(torch, seeded.model.state_dict(), cfg, directory)
    snaps = {m: os.path.join(directory, f"{m}.dsq") for m in ("q4_k", "q6_k")}
    for method, path in snaps.items():
        export_snapshot(torch, index, config, path, method, device)
    return index, snaps


# per family, seeds whose greedy selections all clear 1e-3
# (test_smoke_family_parity_seed_has_no_near_tie in tests/test_torch_paddle.py
# and tests/test_torch_glm.py)
FAMILY_PARITY_SEED = {"ocr2": 0, "paddle": 3, "dots": 11, "glm": 4}
FAMILY_PARITY_VISION = {"ocr2": (128, 128, False), "paddle": (64, 64, False), "dots": (64, 64, False),
                        "glm": (64, 64, False)}
# Dots' smart-resize keeps its 147,384-pixel floor: a 60 × 60 image takes
# 196 tokens, so its rows need more than 256 positions
FAMILY_PARITY_SLOT_SEQ = {"dots": 512}


def family_parity_engine(torch, family, device, kv_quant=None, state=None):
    """Phase 5's tiny f32 engine of a new family ("ocr2": the tiny DeepSeek
    decoder behind SAM and the tiny Qwen2 encoder; "paddle": the tiny
    PaddleOCR-VL, 4 query heads over 2 KV heads; "dots" and "glm": the tiny
    DotsOCR and GLM-OCR, 4 query heads over 2), FAMILY_PARITY_SEED's
    weights or `state`."""
    seed = FAMILY_PARITY_SEED[family]
    if family == "ocr2":
        from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config
        from dsocr_tpu_torch.models.deepseek.ocr2 import tiny_qwen2_encoder_params

        cfg = dataclasses.replace(tiny_deepseek_config(), variant="ocr2", clip=None)
        return DeepseekOcrEngine(cfg, dtype=torch.float32, device=device, max_seq_len=512, seed=seed,
                                 kv_quant=kv_quant, state=state, ocr2_params=tiny_qwen2_encoder_params())
    if family == "dots":
        from dsocr_tpu_torch.models.dots import DotsOcrEngine, tiny_dots_config

        return DotsOcrEngine(tiny_dots_config(), dtype=torch.float32, device=device, max_seq_len=512, seed=seed,
                             kv_quant=kv_quant, state=state, quantize=None)
    if family == "glm":
        from dsocr_tpu_torch.models.glm import GlmOcrEngine, tiny_glm_config

        return GlmOcrEngine(tiny_glm_config(), dtype=torch.float32, device=device, max_seq_len=512, seed=seed,
                            kv_quant=kv_quant, state=state)
    from dsocr_tpu_torch.models.paddleocr import PaddleOcrEngine, tiny_paddle_config

    return PaddleOcrEngine(tiny_paddle_config(), dtype=torch.float32, device=device, max_seq_len=512,
                           seed=seed, kv_quant=kv_quant, state=state)


def family_parity(torch, K, images, params):
    """Phase 5's new families at their tiny configs: one set of weights on
    the CPU and the card, 2 slots, f32 and int8 KV → {key: value} (the
    `_equal` keys must be true; the attention kernels must launch)."""
    from dsocr_tpu_torch.core import VisionSettings

    result = {}
    for family in FAMILY_PARITY_SEED:
        state = family_parity_engine(torch, family, "cpu").model.state_dict()
        vision = VisionSettings(*FAMILY_PARITY_VISION[family])
        for kv_quant in (None, "int8"):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = family_parity_engine(torch, family, device, kv_quant, state)
                K.reset_launches()
                outs, _ = serve(eng, TinyTokenizer(), images, vision, params, n_slots=2,
                                max_len=FAMILY_PARITY_SLOT_SEQ.get(family, 256), chunk=8)
                tokens[device] = [o.generated_tokens for o in outs]
            key = f"{family}_2slots_{kv_quant or 'f32'}"
            counts = K.launch_counts()
            result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
            result[f"{key}_tokens_cuda"] = tokens["cuda"]
            result[f"{key}_launches"] = {name: counts[name] for name in
                                         ("flash_prefill_attention", "slot_kv_write", "slot_decode_attention")}
            require(all(result[f"{key}_launches"].values()), f"{key}: an attention kernel did not run")
    return result


def parity_phase(torch):
    """Phase 5: tiny config, same weights, CUDA kernels vs CPU twins."""
    import shutil

    import numpy as np

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config

    cfg = tiny_deepseek_config()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(3)]
    params = DecodeParameters(max_new_tokens=PARITY_NEW, no_repeat_ngram_size=None)
    vision = VisionSettings(64, 64, False)
    cpu = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=PARITY_SEED)
    state = cpu.model.state_dict()
    result = {"phase": "parity"}
    for kv_quant in (None, "int8"):
        tokens, speculated = {}, {}
        for device in ("cpu", "cuda"):
            eng = DeepseekOcrEngine(cfg, dtype=torch.float32, device=device, max_seq_len=512,
                                    kv_quant=kv_quant, state=state)
            outs, sched = serve(eng, TinyTokenizer(), images, vision, params,
                                n_slots=2, max_len=256, chunk=8)
            tokens[device] = [o.generated_tokens for o in outs]
            speculated[device] = sched.speculated_chunks
        key = kv_quant or "f32"
        result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"{key}_tokens_cuda"] = tokens["cuda"]
        result[f"{key}_speculated_chunks"] = speculated  # the scheduler's default is on, both sides
    # Q8_0: every contraction dim % 32, so the routed experts pack too.
    # K-quants: hidden 256 puts the projections' in dims on the 256-value
    # super-block; the down projections (in dim 32) pack as Q8_0, a mixed
    # expert group as at full width.
    from dsocr_tpu_torch.ops import kernels as K

    lang32 = dataclasses.replace(cfg.language, moe_intermediate_size=32)
    # moe_intermediate_size 256 packs the down projections as the K-quant
    # too: the one served path that reaches q4k_/q6k_dense_experts_perx.
    def kq(inter):
        lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=inter)
        return dataclasses.replace(cfg, projector_n_embed=256, language=lang)

    formats = (
        ("q8_0", "q8", dataclasses.replace(cfg, language=lang32), PARITY_SEED,
         ((2, "q8_gather_matmul"), (4, "q8_dense_experts"))),
        ("q4_k", "q4k", kq(32), PARITY_SEED, ((2, "q4k_gather_matmul"), (4, "q4k_dense_experts"))),
        ("q4_k", "q4k_all", kq(256), PARITY_SEED, ((4, "q4k_dense_experts_perx"),)),
        ("q6_k", "q6k", kq(32), Q6K_PARITY_SEED, ((2, "q6k_gather_matmul"), (4, "q6k_dense_experts"))),
        ("q6_k", "q6k_all", kq(256), Q6K_PARITY_SEED, ((4, "q6k_dense_experts_perx"),)),
    )
    for method, tag, qcfg, seed, tiers in formats:
        cpu = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=seed,
                                quantize=method)
        state = cpu.model.state_dict()
        for n_slots, tier in tiers:
            for kv_quant in (None, "int8"):
                tokens = {}
                for device in ("cpu", "cuda"):
                    eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                            kv_quant=kv_quant, state=state, quantize=method)
                    K.reset_launches()
                    outs, _ = serve(eng, TinyTokenizer(), images, vision, params,
                                    n_slots=n_slots, max_len=256, chunk=8)
                    tokens[device] = [o.generated_tokens for o in outs]
                key = f"{tag}_{n_slots}slots_{kv_quant or 'f32'}"
                result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
                result[f"{key}_{tier}_launches"] = K.launch_counts()[tier]
                result[f"{key}_tokens_per_request"] = [len(t) for t in tokens["cuda"]]
                require(K.launch_counts()[tier] > 0, f"{key}: the {tier} tier did not run on the card")
    # paged KV + the megafused chain on the Q8_0 config at 4 slots (the
    # dense tier); a pool of 2 pages holds 2 of the 4 rows, so the third
    # request waits for pages on the card as on the CPU
    qcfg = dataclasses.replace(cfg, language=lang32)
    state = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                              seed=PARITY_SEED, quantize="q8_0").model.state_dict()
    for kv_quant, pool in ((None, None), ("int8", None), (None, "2")):
        pool_env = {"DSOCR_POOL_PAGES": pool} if pool else {}
        with environ(DSOCR_PAGED_KV="1", DSOCR_Q8_MEGAFUSED="1", **pool_env):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                        kv_quant=kv_quant, state=state, quantize="q8_0")
                K.reset_launches()
                outs, sched = serve(eng, TinyTokenizer(), images, vision, params,
                                    n_slots=4, max_len=256, chunk=8)
                tokens[device] = [o.generated_tokens for o in outs]
        key = f"q8_paged_4slots_{kv_quant or 'f32'}" + (f"_pool{pool}" if pool else "")
        counts = K.launch_counts()
        result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"{key}_launches"] = {name: counts[name] for name in
                                     ("q8_moe_megafused", "paged_kv_write", "paged_decode_attention")}
        result[f"{key}_max_occupancy"] = max(sched.batch_sizes)
        require(all(result[f"{key}_launches"].values()), f"{key}: a paged or megafused kernel did not run")
        require(not pool or max(sched.batch_sizes) <= int(pool), f"{key}: more rows than the pool holds")
    # weights from files at hidden 256: FILES_PARITY_SEED's float weights
    # as a checkpoint, its Q4_K and Q6_K snapshots exported on the
    # card, each loaded on the card and on the CPU: packed tensors equal,
    # greedy tokens equal at 4 slots, int8 KV
    index, snaps = files_parity(torch, kq(32), os.path.join(WEIGHTS_DIR, "parity"))
    for method, snapshot in snaps.items():
        states, tokens = {}, {}
        for device in ("cpu", "cuda"):
            eng = file_engine(torch, kq(32), index, snapshot, method, device, kv_quant="int8")
            states[device] = {k: v.cpu() for k, v in eng.model.state_dict().items()}
            outs, _ = serve(eng, TinyTokenizer(), images, vision, params, n_slots=4, max_len=256, chunk=8)
            tokens[device] = [o.generated_tokens for o in outs]
        result[f"files_{method}_packed_equal"] = states["cpu"].keys() == states["cuda"].keys() and all(
            torch.equal(v, states["cuda"][k]) for k, v in states["cpu"].items())
        result[f"files_{method}_tokens_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"files_{method}_tokens_cuda"] = tokens["cuda"]
    shutil.rmtree(os.path.join(WEIGHTS_DIR, "parity"), ignore_errors=True)
    # single-request decode (engine.decode over a contiguous KV cache), with
    # and without the cache, f32 and Q8_0 weights (the gather tier at N = 1)
    for tag, qcfg, method in (("f32", cfg, None), ("q8", dataclasses.replace(cfg, language=lang32), "q8_0")):
        state = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                                  seed=PARITY_SEED, quantize=method).model.state_dict()
        for use_cache in (True, False):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                        state=state, quantize=method)
                out = eng.decode(TinyTokenizer(), PROMPT, images[:1], vision,
                                 DecodeParameters(max_new_tokens=16 if use_cache else 6,
                                                  use_cache=use_cache))
                tokens[device] = out.generated_tokens
            key = f"decode_{tag}_{'cache' if use_cache else 'nocache'}"
            result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
            result[f"{key}_tokens_cuda"] = tokens["cuda"]
    result.update(family_parity(torch, K, images, params))
    emit(result)
    require(all(v for k, v in result.items() if k.endswith("_equal")), "CUDA and CPU greedy tokens differ")


MESH = "dp=1,mp=2"  # two ranks sharing the one card
MESH_REQUESTS, MESH_NEW, MESH_SLOTS = 4, 32, 4  # (a), (b): 4 × 32 over 4 slots (× 64 before the image-format lines)
MESH_PAGED = (2, 32)  # (c): 2 × 32 over 2 slots, DSOCR_PAGED_KV=1
MESH_STEPS = 16  # decode steps of the per-step line
# bf16 logit tolerance between a mesh and the single-process engine, about
# twice the largest prefill-logit difference read on the card (0.032): the
# prefill logits must agree within it, and a token may differ only where
# the single-process top-2 margin is below it (a greedy near-tie). The
# seed must be clear of near-ties (mesh_seed_margin): every margin of a
# case above it, so that no differing token can pass
MESH_LOGIT_TOL = 0.0625
MESH_DEADLINE_S = 600.0
MESH_REFS = {}  # case → the single-process engine's tokens, margins and prefill logits


def mesh_page(engine):
    """A DeepSeek engine's side of a mesh case: (tokenizer, the page, its
    vision settings, → the page's join packet)."""
    image, vision, tokens, mask, emb = page_packet(engine)
    return BenchTokenizer(), image, vision, lambda: engine._prefill_rows([(tokens, mask, [emb])])[0]


def dense_page(engine, tokenizer, image, vision):
    """A dense family's side of a mesh case (mesh_page): the page's packet
    through the engine's towers and prefill."""
    return tokenizer, image, vision, lambda: engine.prefill_for_slot(tokenizer, PROMPT, [image], vision)


def mesh_reference(torch, engine, case, n_requests, n_slots, max_new, paged=False, page=None):
    """Case `case` of a mesh phase on the single-process `engine` (`page`:
    mesh_page's, the default, or dense_page's): its burst's tokens, the
    top-2 logit margin of every token (the first from the page's packet,
    then each decode step's on its longest row) and the page's prefill
    logits, kept in MESH_REFS."""
    from dsocr_tpu_torch.core import DecodeParameters

    tokenizer, image, vision, packet = page or mesh_page(engine)
    pre = packet()
    margins = [top2_margin(torch, pre["logits"][None])[0]]
    step = engine.slot_step_fn

    def spy(decoder, token_ids, cache, pos):
        logits = step(decoder, token_ids, cache, pos)
        margins.append(top2_margin(torch, logits)[int(cache.lengths.argmax())])
        return logits

    engine.slot_step_fn = engine.slot_step_fn_paged = spy
    try:
        with environ(DSOCR_PAGED_KV="1" if paged else "0"):
            outs, _ = serve(engine, tokenizer, [image] * n_requests, vision,
                            DecodeParameters(max_new_tokens=max_new), n_slots=n_slots,
                            max_len=mesh_max_len(engine, pre["prompt_ids"], max_new), chunk=CHUNK)
    finally:
        del engine.slot_step_fn, engine.slot_step_fn_paged
    MESH_REFS[case] = dict(tokens=[o.generated_tokens for o in outs], margins=margins,
                           logits=pre["logits"].float().cpu())
    least, step = mesh_seed_margin(margins)
    emit({"phase": "mesh_reference", "case": case, "tokens": len(margins), "min_top2_margin": least,
          "at_step": step, "logit_tol": MESH_LOGIT_TOL})
    require(least > MESH_LOGIT_TOL, f"mesh case {case}: the seed has a greedy near-tie (top-2 margin "
            f"{least} at step {step}, not above {MESH_LOGIT_TOL})")


def mesh_seed_margin(margins):
    """The least single-process top-2 margin of a case and its step; the
    seed is clear of near-ties when it is above MESH_LOGIT_TOL."""
    step = min(range(len(margins)), key=margins.__getitem__)
    return margins[step], step


def top2_margin(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).tolist()


def mesh_max_len(engine, tokens, max_new):
    s_pad = -(-len(tokens) // 128) * 128
    return min(engine.max_seq_len, -(-(s_pad + max_new) // 512) * 512)


def mesh_parity(ref, got):
    """Each request's tokens against the single-process burst's; where one
    differs, its first differing step and the single-process top-2 margin
    there (→ (fields, ok): ok when equal, or the margin is below
    MESH_LOGIT_TOL)."""
    want = ref["tokens"][0]
    equal = [g == want for g in got]
    fields = {"requests_equal": sum(equal), "tokens_equal_single_process": all(equal)}
    ok = True
    for g in got:
        if g == want:
            continue
        first = next((i for i, (a, b) in enumerate(zip(g, want)) if a != b), min(len(g), len(want)))
        margin = ref["margins"][first] if first < len(ref["margins"]) else None
        fields.setdefault("first_differing_step", first)
        fields.setdefault("single_process_top2_margin", margin)
        ok = ok and margin is not None and margin < MESH_LOGIT_TOL
    return fields, ok


def mesh_burst(torch, phase, engine, case, n_requests, n_slots, max_new, required, unused=(), page=None):
    """Case `case` on the mesh engine (`page` as mesh_reference's): the
    burst through ContinuousScheduler with every rank's counters zeroed just
    before and read just after (each kernel in `required` launched on every
    rank, none in `unused`), its tokens against the single-process burst's
    (mesh_parity), the page's prefill logits against the single-process
    ones within MESH_LOGIT_TOL, then MESH_STEPS decode steps of the page's
    packet in every slot: per step, each rank's launches and collectives
    and rank 0's host ms, and each rank's share of the slot cache. → rank
    0's launch counts."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.runtime.paged import PagedSlotCache

    ref = MESH_REFS[case]
    runtime = engine.mesh_runtime
    tokenizer, image, vision, packet = page or mesh_page(engine)
    pre = packet()
    tokens = pre["prompt_ids"]
    max_len = mesh_max_len(engine, tokens, max_new)
    torch.cuda.synchronize()
    runtime.stats(reset=True)
    t0 = time.perf_counter()
    outs, sched = serve(engine, tokenizer, [image] * n_requests, vision,
                        DecodeParameters(max_new_tokens=max_new), n_slots=n_slots, max_len=max_len, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ranks = runtime.stats(reset=True)
    got = [o.generated_tokens for o in outs]
    parity, parity_ok = mesh_parity(ref, got)
    logits = pre["logits"].float().cpu()
    diff = float((logits - ref["logits"]).abs().max())

    # the per-step line: the packet in every slot, steps that never end
    if os.environ.get("DSOCR_PAGED_KV") == "1":
        runner, cache = engine.make_paged_slot_runner(n_slots, max_len)
    else:
        runner, cache = engine.make_slot_runner(), engine.new_slot_cache(n_slots, max_len)
    runner.eos_ids = ()
    state = runner.init_state(cache, max_len)
    runner.join_many(state, list(range(n_slots)), [pre] * n_slots, [DecodeParameters()] * n_slots,
                     [max_len - len(tokens)] * n_slots, [None] * n_slots)
    runner.run_chunk(engine.params, state, 4)
    torch.cuda.synchronize()
    runtime.stats(reset=True)
    step_ms = synced_ms(torch, lambda: runner.run_chunk(engine.params, state, MESH_STEPS), MESH_STEPS)
    per_step = runtime.stats(reset=True)
    shares = runtime.cache_shapes(cache) if not isinstance(cache, PagedSlotCache) else None
    del state, cache, runner
    mesh = engine.mesh
    emit({"phase": phase, "quantize": engine.quantize, "kv_quant": engine.kv_quant,
          "mesh": f"dp={mesh.dp},mp={mesh.mp}" + (",ep" if mesh.ep else ""),
          "backend": runtime.ranks.backend, "requests": len(outs), "slots": n_slots, "new_tokens": max_new,
          "prompt_tokens": len(tokens), "wall_s": wall, "tokens_per_request": [len(g) for g in got], **parity,
          "min_top2_margin": mesh_seed_margin(ref["margins"])[0],
          "prefill_logits_max_abs_diff": diff, "logit_tol": MESH_LOGIT_TOL,
          "ranks": [{"rank": r, "device": f"cuda:{st['device_index']}", "peak_mib": st["peak_mib"],
                     "slot_cache": shares[r] if shares else None,
                     "burst_launches": {k: v for k, v in st["launches"].items() if v},
                     "burst_collectives": st["collectives"],
                     "launches_per_step": {k: v / MESH_STEPS for k, v in per_step[r]["launches"].items() if v},
                     "collectives_per_step": {k: v / MESH_STEPS for k, v in per_step[r]["collectives"].items()}}
                    for r, st in enumerate(ranks)],
          "host_ms_per_step": step_ms,
          "host_ms_per_step_note": "two ranks sharing one card — not a multi-card figure"})
    require(len(outs) == n_requests, f"{phase}: not every request completed")
    require(bool(torch.isfinite(logits).all()), f"{phase}: non-finite logits")
    require(diff < MESH_LOGIT_TOL, f"{phase}: prefill logits {diff} off the single-process engine's")
    require(parity_ok, f"{phase}: tokens differ from the single-process engine's where it was not a near-tie: {parity}")
    for r, st in enumerate(ranks):
        for name in required:
            require(st["launches"][name] > 0, f"{phase}: kernel {name} was not launched on rank {r}")
        for name in unused:
            require(st["launches"][name] == 0, f"{phase}: kernel {name} was launched on rank {r}")
    return ranks[0]["launches"]


def mesh_phase(torch, K, smi, attention, codes_in):
    """DeepSeek-OCR v1 at full width over two ranks on the one card
    (dp=1, mp=2), the seeded weights and page: (a) bf16 TP with int8 KV,
    a 4 × 32 burst over 4 slots (MESH_NEW), (c) the same engine with
    DSOCR_PAGED_KV=1 at 2 × 32, then (b) Q8_0 expert-parallel (``ep``) at
    4 × 32; one set
    of rank processes for the three. Each held to MESH_REFS (the
    single-process engine's bursts on the same weights). Case (d), the
    server under --mesh, runs in the frontends phase. → rank 0's launch
    counts of the three bursts."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, DeepseekOcrEngine
    from dsocr_tpu_torch.parallel import launch

    t_phase = t0 = time.perf_counter()
    ranks = launch.start(2, "cuda", deadline=MESH_DEADLINE_S)
    start_s = time.perf_counter() - t0
    bursts = []
    try:
        def build(**kw):
            t = time.perf_counter()
            engine = DeepseekOcrEngine(DeepseekOcrConfig(), dtype=torch.bfloat16, device="cuda", max_seq_len=4096,
                                       seed=0, kv_quant="int8", ranks=ranks, **kw)
            torch.cuda.synchronize()
            stats = engine.mesh_runtime.stats(reset=True)
            emit({"phase": "mesh_init", "mesh": kw["mesh"], "quantize": kw.get("quantize"),
                  "backend": ranks.backend, "start_s": start_s, "init_s": time.perf_counter() - t,
                  "peak_mib": [st["peak_mib"] for st in stats],
                  "devices": [f"cuda:{st['device_index']}" for st in stats],
                  "heads_per_rank": engine.model.decoder.n_heads,
                  "experts_per_rank": engine.model.decoder.shard.experts, "nvidia_smi": smi})
            return engine

        engine = build(mesh=MESH)
        bursts.append(mesh_burst(torch, "mesh_tp", engine, "a", MESH_REQUESTS, MESH_SLOTS, MESH_NEW,
                                 required=attention, unused=codes_in))
        with environ(DSOCR_PAGED_KV="1"):
            bursts.append(mesh_burst(torch, "mesh_tp_paged", engine, "c", MESH_PAGED[0], MESH_PAGED[0],
                                     MESH_PAGED[1], required=["paged_kv_write", "paged_decode_attention"],
                                     unused=codes_in + ["slot_kv_write", "slot_decode_attention"]))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine = build(mesh=MESH + ",ep", quantize="q8_0")
        bursts.append(mesh_burst(torch, "mesh_ep_q8", engine, "b", MESH_REQUESTS, MESH_SLOTS, MESH_NEW,
                                 required=attention + ["q8_matmul", "q8_gather_matmul"], unused=codes_in))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ranks.close()
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase})
    return bursts


# the mesh_dense phase's cases: (case, family, mesh, packed format, weight
# seed), each a burst of MESH_DENSE_BURST on the seeded full-width engine
# over two ranks sharing the card, held to MESH_REFS[case] (taken in
# families_phase and families2_phase on the single-process engine of the
# same weights). The seeds are clear of greedy near-ties: every
# single-process top-2 margin of the case's burst above MESH_LOGIT_TOL
# (`python3 mesh_seeds.py seeds` on an NVIDIA H100 80GB HBM3, 700.00 W:
# Paddle seed 7 0.1269, seeds 0-6 and 8 below; Dots seed 0 0.1014; GLM
# seed 1 0.0789, seeds 0 and 2-6 below, 7 0.0725)
MESH_DENSE = (
    ("e", "paddle", "dp=2,mp=1", "q8_0", 7),  # rows over dp: q8_matmul on 2 of the 4 rows a rank
    ("f", "dots", "dp=1,mp=2", "q8_0", 0),  # 6 query heads over 1 KV head a rank, packed projections replicated
    ("g", "glm", "dp=1,mp=2", None, 1),  # 8 query heads over 4 KV heads a rank
)
MESH_DENSE_BURST = (4, 4, 32)  # requests, slots, new tokens
# (h): family_frontends' server under --mesh MESH, one request of
# MESH_SERVER_NEW tokens. The request is clear of greedy near-ties: every
# single-process top-2 margin of its decode steps above MESH_LOGIT_TOL
# (`python3 mesh_seeds.py requests` on an NVIDIA H100 80GB HBM3, 700.00 W:
# least 0.0677; "Free OCR." at 64 tokens sits at 0.0140, at 32 tokens
# "OCR this page." at 0.0266, "Read the text." at 0.0186)
MESH_SERVER_MODEL = "dots-ocr"
MESH_SERVER_TEXT = "Convert the document to markdown."
MESH_SERVER_NEW = 32


def dense_engine(torch, family, quantize=None, seed=0, **kw):
    """The seeded full-width engine of a mesh_dense case (int8 KV; Dots' and
    GLM's f32 towers rounded to bf16 values, as families2_phase serves
    them); `kw`: mesh and ranks."""
    from dsocr_tpu_torch.models.dots import DotsConfig, DotsOcrEngine
    from dsocr_tpu_torch.models.glm import GlmConfig, GlmOcrEngine
    from dsocr_tpu_torch.models.paddleocr import PaddleConfig, PaddleOcrEngine

    common = dict(dtype=torch.bfloat16, device="cuda", seed=seed, kv_quant="int8", **kw)
    if family == "paddle":
        return PaddleOcrEngine(PaddleConfig(), max_seq_len=4096, quantize=quantize, **common)
    if family == "dots":
        engine = DotsOcrEngine(DotsConfig(), max_seq_len=GLM_SLOT_SEQ, quantize=quantize, **common)
    else:
        engine = GlmOcrEngine(GlmConfig(), max_seq_len=GLM_SLOT_SEQ, **common)
    round_tower_(torch, engine)
    return engine


def dense_mesh_reference(torch, case):
    """MESH_REFS[case] from the case's seeded engine on one process."""
    _, family, _, quantize, seed = next(c for c in MESH_DENSE if c[0] == case)
    engine = dense_engine(torch, family, quantize, seed=seed)
    mesh_reference(torch, engine, case, *MESH_DENSE_BURST, page=dense_case_page(engine, family))
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def dense_case_page(engine, family):
    """The families phases' page, vision and tokenizer for `family`."""
    from dsocr_tpu_torch.core import VisionSettings

    page = seeded_page()[0]
    if family == "paddle":
        return dense_page(engine, PaddleBenchTokenizer(), page, VisionSettings(1024, PADDLE_IMAGE_SIZE, False))
    return dense_page(engine, BenchTokenizer(), page, VisionSettings(1024, 0, False))


def mesh_dense_phase(torch, K, smi):
    """PaddleOCR-VL, DotsOCR and GLM-OCR at full width over two ranks on the
    one card, one set of rank processes for the three MESH_DENSE cases:
    params replicated, (e) slot rows over dp, (f) and (g) KV heads over
    mp. Each case's init line (init_s, each rank's peak MiB and heads),
    then its burst (mesh_burst: each rank's launches a step and a burst,
    collectives a step, host ms a step, its slot-cache share, the least
    single-process top-2 margin), held to MESH_REFS. → rank 0's launch
    counts of the three bursts."""
    from dsocr_tpu_torch.parallel import launch

    t_phase = t0 = time.perf_counter()
    ranks = launch.start(2, "cuda", deadline=MESH_DEADLINE_S)
    start_s = time.perf_counter() - t0
    bursts = []
    try:
        for case, family, mesh, quantize, seed in MESH_DENSE:
            t = time.perf_counter()
            engine = dense_engine(torch, family, quantize, seed=seed, mesh=mesh, ranks=ranks)
            torch.cuda.synchronize()
            stats = engine.mesh_runtime.stats(reset=True)
            share = engine.mesh_runtime.share
            cfg = engine.model.decoder.cfg
            emit({"phase": "mesh_dense_init", "case": case, "family": family, "mesh": mesh, "quantize": quantize,
                  "seed": seed,
                  "backend": ranks.backend, "start_s": start_s, "init_s": time.perf_counter() - t,
                  "peak_mib": [st["peak_mib"] for st in stats],
                  "devices": [f"cuda:{st['device_index']}" for st in stats],
                  "heads_per_rank": [share.nq, share.nkv] if share else
                  [cfg.num_attention_heads, cfg.resolved_num_key_value_heads], "nvidia_smi": smi})
            required = FAMILY_ATTENTION + (["q8_matmul"] if quantize else [])
            bursts.append(mesh_burst(torch, f"mesh_dense_{family}", engine, case, *MESH_DENSE_BURST,
                                     required=required, unused=["slot_kv_update", "sam_flash_attention"],
                                     page=dense_case_page(engine, family)))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ranks.close()
    emit({"phase": "mesh_dense", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return bursts


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dsocr_tpu_torch")):
        print("chip_smoke: the dsocr_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops import kernels as K
    from dsocr_tpu_torch.ops.kernels import _lib

    set_f32_precision()
    smi = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    t0 = time.perf_counter()
    _lib.lib()
    emit({"phase": "build", "nvcc_s": _lib.build_info.get("nvcc_s"),
          "load_s": time.perf_counter() - t0, "library": os.path.relpath(_lib.build_info["path"], HERE)})

    cases = check_kernels(torch, K)
    slot = ["slot_kv_write", "slot_decode_attention"]
    # the codes-in writes of the reference's contract: phase 3 only, since
    # the decode step's writes quantize the token themselves
    codes_in = ["slot_kv_update", "paged_kv_update"]
    attention = ["sam_flash_attention", "flash_prefill_attention"] + slot
    engine = full_width_engine(torch)
    mesh_reference(torch, engine, "a", MESH_REQUESTS, MESH_SLOTS, MESH_NEW)
    mesh_reference(torch, engine, "c", MESH_PAGED[0], MESH_PAGED[0], MESH_PAGED[1], paged=True)
    host_prep_phase(torch, engine)
    bursts = [serving_phase(torch, K, "serve", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
                            max_new=MAX_NEW, required=attention, unused=codes_in, profile=True,
                            towers=True)[0]]
    # Phase 4's gate cannot open: a chunk of 128 steps and 128 new tokens
    # never leave two chunks of budget (emitted + 2 · 128 <= 128). The same
    # requests at 64 tokens in chunks of 16 must speculate: rows join at
    # chunk boundaries, so the first wave's 4 rows have emitted 0, 16, 32
    # or 48 tokens when the other 12 join, or have left. Up to 32 opens the
    # gate at once (32 + 2 · 16 <= 64, no free slot); 48 opens it a chunk
    # later, when those rows have left, no prefill is left and the other
    # rows have emitted 16; rows that have left open it at the 12's first
    # chunk.
    bursts.append(serving_phase(torch, K, "serve_spec", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
                                max_new=SPEC_MAX_NEW, required=attention, unused=codes_in, warmup=False,
                                chunk=SPEC_CHUNK, speculate=True)[0])
    bursts.append(sched_phase(torch, K, engine))
    bursts.append(split_phase(torch, K, engine))
    prefill = ["sam_flash_attention", "flash_prefill_attention"]
    bursts.append(decode_phase(torch, K, engine, smi, required=prefill, debug_dumps=True))
    towers_f32_phase(torch, K, engine, smi)
    bursts += weights_phase(torch, K, engine, required=attention + [
        "q6k_matmul", "q6k_dense_experts", "q8_dense_experts_perx"], unused=codes_in,
        then=lambda index, config, q8: frontends_phase(torch, K, index, config, q8, required=attention))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q8_0")
    sweep = ["q8_dense_experts", "q8_dense_experts_perx"]
    launches, q8_tokens = serving_phase(
        torch, K, "serve_q8", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q8_matmul"] + sweep, unused=codes_in, warmup=False, profile=True)
    bursts.append(launches)
    bursts.append(serving_phase(
        torch, K, "serve_q8_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    bursts.append(decode_phase(torch, K, engine, smi,
                               required=prefill + ["q8_matmul", "q8_gather_matmul"]))
    mesh_reference(torch, engine, "b", MESH_REQUESTS, MESH_SLOTS, MESH_NEW)
    # the same engine with a shared page pool that holds 12 of the 16 rows
    # (9 pages each of 108) and the megafused expert chain
    with environ(DSOCR_PAGED_KV="1", DSOCR_Q8_MEGAFUSED="1", DSOCR_POOL_PAGES="108"):
        bursts.append(serving_phase(
            torch, K, "serve_q8_paged", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
            max_new=MAX_NEW, required=["paged_kv_write", "paged_decode_attention",
                                       "q8_moe_megafused", "q8_matmul"],
            unused=slot + sweep + codes_in, warmup=False, profile=True, same_as=q8_tokens)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    bursts += mesh_phase(torch, K, smi, attention, codes_in)
    engine = full_width_engine(torch, quantize="q4_k")
    bursts.append(serving_phase(
        torch, K, "serve_q4k", engine, n_requests=CUT_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q4k_matmul", "q4k_dense_experts", "q8_dense_experts_perx"],
        unused=codes_in, warmup=False, profile=True)[0])
    bursts.append(serving_phase(
        torch, K, "serve_q4k_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q4k_gather_matmul", "q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q6_k")
    bursts.append(serving_phase(
        torch, K, "serve_q6k", engine, n_requests=CUT_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q6k_matmul", "q6k_dense_experts", "q8_dense_experts_perx"],
        unused=codes_in, warmup=False)[0])  # Q6_K's profile: serve_q6k_snapshot's engine, the same shapes
    bursts.append(serving_phase(
        torch, K, "serve_q6k_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q6k_gather_matmul", "q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    bursts.append(families_phase(torch, K, smi))
    bursts.append(families2_phase(torch, K, smi))
    bursts += mesh_dense_phase(torch, K, smi)
    launches = {name: sum(b[name] for b in bursts) for name in bursts[0]}
    parity_phase(torch)

    # per kernel: the worst error over its cases; the times and bound of its first case
    summary = []
    for fn, source, replaces in K.KERNELS:
        mine = [c for c in cases if c["kernel"] == fn.__name__]
        summary.append({
            "name": fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[fn.__name__],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            **{key: mine[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
