"""Meshes on torch.distributed (dsocr_tpu/parallel): a ("dp", "mp") grid
of rank processes, one per shard. ``mesh`` holds the grid and the
sharding rules, ``comm`` the collectives, ``launch`` the rank processes
and ``runtime`` the machinery by which rank 0 serves and the followers
mirror its sharded device work: DeepSeek-OCR's operations
(models/deepseek/mesh.py: towers split over the ranks, the decoder
sharded over heads, MLP, experts and vocabulary) and the dense
families' (models/gqa_mesh.py: PaddleOCR-VL, DotsOCR and GLM-OCR with
params replicated, the slot cache's rows over dp and KV heads over mp,
``alloc_slots``, ``prefill_packets`` and ``slot_step``)."""

from .mesh import (
    Mesh,
    cache_sharding,
    deepseek_param_shardings,
    make_mesh,
    parse_mesh_spec,
    pool_scale_sharding,
    pool_sharding,
    row_cache_sharding,
    scale_sharding,
    shard_tensor,
    slot_cache_sharding,
    slot_scale_sharding,
)

__all__ = [
    "Mesh",
    "cache_sharding",
    "deepseek_param_shardings",
    "make_mesh",
    "parse_mesh_spec",
    "pool_scale_sharding",
    "pool_sharding",
    "row_cache_sharding",
    "scale_sharding",
    "shard_tensor",
    "slot_cache_sharding",
    "slot_scale_sharding",
]
