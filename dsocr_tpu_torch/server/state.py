"""Server state (dsocr_tpu/server/state.py): the registry, one resident
model loaded lazily and swapped when a request names another registry
id, and the scheduler that serves it.

An engine with the slot surface (``make_slot_runner``: DeepSeek) is
served by ContinuousScheduler. An engine without it would get the
reference's BatchScheduler, which is not ported (ROADMAP Queue 1 #4): such
an engine serves one request at a time through ``engine.decode`` under
the model lock, the reference's own path for requests its scheduler
cannot take.

A swap stops the old scheduler (it waits for the requests it holds, then
drops its runner and slot cache) and drops every reference to the old
engine, then frees the card's cached blocks, before the factory builds
the new engine: two full-width engines do not fit one card's budget side
by side. The reference replaced its engine after loading the new one.
Under a mesh (``mesh``: models/registry.py's load_engine; every family
has ``alive`` and ``close``) the old engine's rank processes stop at the
swap (``engine.close``) and the new engine spawns its own. A failed call tears a mesh's ranks down
(parallel/runtime.py): the requests it held fail, and the next request
finds the engine no longer ``alive`` and loads the model anew, with new
ranks.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import os
from typing import Any, Optional

import torch

from ..config import AppConfig, VirtualFileSystem, prepare_model_paths
from ..config.app import InferenceSettings
from ..core.engine import ModelKind
from ..models.registry import check_mesh, load_engine
from ..utils.tokenizer import load_tokenizer
from .messages import ApiError
from .scheduler import ContinuousScheduler

logger = logging.getLogger("dsocr.server.state")


@dataclasses.dataclass
class LoadedModel:
    model_id: str
    engine: Any
    tokenizer: Any
    kind: ModelKind


class AppState:
    def __init__(self, config: AppConfig, vfs: Optional[VirtualFileSystem] = None, max_seq_len: int = 8192,
                 engine_factory=None, mesh=None, kv_quant=None, prefix_cache=None, device=None):
        self.config = config
        self.vfs = vfs or VirtualFileSystem()
        self.max_seq_len = max_seq_len
        self.mesh = mesh
        self.kv_quant = kv_quant or os.environ.get("DSOCR_KV_QUANT") or None
        self.prefix_cache = prefix_cache
        self.device = device
        self._engine_factory = engine_factory or self._default_factory
        self._loaded: Optional[LoadedModel] = None
        self._scheduler: Optional[ContinuousScheduler] = None
        self._lock = asyncio.Lock()  # model swap + serialized decode
        self.metrics = {
            "requests_total": 0,
            "requests_failed": 0,
            "prompt_tokens_total": 0,
            "completion_tokens_total": 0,
            "decode_seconds_total": 0.0,
            "model_swaps_total": 0,
        }

    def validate_model(self, model_id: str) -> None:
        if model_id not in self.config.models.entries:
            raise ApiError(f"model `{model_id}` is not registered", status=400)

    def model_settings(self, model_id: str) -> InferenceSettings:
        return self.config.resolved_inference(model_id)

    def _default_factory(self, model_id: str) -> LoadedModel:
        entry = self.config.models.entries[model_id]
        check_mesh(entry.kind, self.mesh)
        paths = prepare_model_paths(self.config, model_id, vfs=self.vfs)
        engine = load_engine(entry.kind, config_path=paths.config, weights_path=paths.weights,
                             snapshot_path=paths.snapshot, dtype=self.model_settings(model_id).precision,
                             max_seq_len=self.max_seq_len, mesh=self.mesh, kv_quant=self.kv_quant,
                             device=self.device)
        return LoadedModel(model_id=model_id, engine=engine, tokenizer=load_tokenizer(paths.tokenizer),
                           kind=entry.kind)

    async def unload(self) -> None:
        """Drop the resident model (at shutdown)."""
        async with self._lock:
            await self._unload()

    async def _unload(self) -> None:
        """Stop the old scheduler and drop the old engine (the docstring)."""
        if self._scheduler is not None:
            await self._scheduler.close()
        close = getattr(self._loaded.engine, "close", None) if self._loaded is not None else None
        self._scheduler = self._loaded = None
        if close is not None:  # a mesh engine's followers
            close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    async def ensure_model_loaded(self, model_id: str) -> LoadedModel:
        self.validate_model(model_id)
        async with self._lock:
            if self._loaded is not None and not getattr(self._loaded.engine, "alive", True):
                logger.warning("model %s lost its mesh ranks; loading it anew", self._loaded.model_id)
                await self._unload()
            if self._loaded is None or self._loaded.model_id != model_id:
                if self._loaded is not None:
                    logger.info("swapping model %s -> %s", self._loaded.model_id, model_id)
                await self._unload()
                loop = asyncio.get_running_loop()
                loaded = await loop.run_in_executor(None, self._engine_factory, model_id)
                self.metrics["model_swaps_total"] += 1
                if hasattr(loaded.engine, "make_slot_runner"):
                    # continuous batching: mid-flight joins, per-row
                    # params, streaming participation
                    self._scheduler = ContinuousScheduler(loaded.engine, loaded.tokenizer,
                                                          prefix_cache=self.prefix_cache)
                else:
                    logger.warning("model %s has no slot surface: one request at a time through "
                                   "engine.decode (BatchScheduler waits for ROADMAP Queue 1 #4)", model_id)
                self._loaded = loaded
            return self._loaded

    @property
    def loaded(self) -> Optional[LoadedModel]:
        return self._loaded

    @property
    def scheduler(self) -> Optional[ContinuousScheduler]:
        return self._scheduler

    @property
    def lock(self) -> asyncio.Lock:
        return self._lock
