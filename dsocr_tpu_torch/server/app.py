"""The server's entry point (dsocr_tpu/server/app.py):

    python -m dsocr_tpu_torch.server --config config.toml --host 0.0.0.0 --port 8000 [--device cuda|cpu]

config.toml (created with the defaults when missing) → AppState → the
routes on server/http.py. The reference's flags, and ``--device`` (cuda,
the default, or cpu). ``--mesh dp=N,mp=M[,ep]`` serves every family over
dp × mp rank processes (DeepSeek-OCR sharded, PaddleOCR-VL, DotsOCR and
GLM-OCR with params replicated, slot rows over dp and KV heads over mp):
this process is rank 0 and serves; each model load spawns the followers
and a swap stops them (server/state.py). The model loads at its first request. One line is
logged once the server listens; SIGTERM or SIGINT stops it cleanly.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import pathlib
import signal

from ..config import AppConfig, VirtualFileSystem
from ..config.args import add_common_model_args, add_server_bind_args

logger = logging.getLogger("dsocr.server")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dsocr-torch-server")
    add_common_model_args(parser)
    add_server_bind_args(parser)
    parser.add_argument("--device", default=None, help="cuda | cpu (default: the config's, cuda)")
    parser.add_argument("--max-seq-len", type=int, default=8192)
    return parser


async def serve(state, host: str, port: int, stop: asyncio.Event = None) -> None:
    """Serve until `stop` is set (SIGTERM/SIGINT set it when None)."""
    from .routes import build_server

    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    server = build_server(state)
    bound_host, bound_port = await server.start(host, port)
    logger.info("listening on http://%s:%d (model %s, device %s)", bound_host, bound_port,
                state.config.models.active, state.device)
    try:
        await stop.wait()
    finally:
        await server.close()
        await state.unload()  # a mesh engine's followers stop with it
        logger.info("stopped")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..core.runtime_device import apply_device_selection
    from ..parallel.mesh import parse_mesh_spec
    from ..utils.logging import init_logging
    from .state import AppState

    init_logging()
    mesh = parse_mesh_spec(args.mesh)  # a malformed spec fails before the server starts
    path = pathlib.Path(args.config) if args.config else VirtualFileSystem().config_file()
    config = AppConfig.load_or_init(path)
    if args.model:
        config.models.active = args.model
    host = args.host or config.server.host
    port = args.port if args.port is not None else config.server.port
    device = apply_device_selection(args.device or config.inference.device)
    state = AppState(config, max_seq_len=args.max_seq_len, kv_quant=args.kv_quant,
                     prefix_cache=args.prefix_cache, device=device, mesh=mesh)
    asyncio.run(serve(state, host, port))
    return 0
