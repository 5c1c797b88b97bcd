"""ops/packed_attention.segment_attention against the reference's
(dsocr_tpu/ops/packed_attention.py) on the same packed q/k/v: through the
reference's one-shot masked softmax (N ≤ query_chunk) and its chunked
online softmax (small query and key chunks that split frames), at f32
tolerance (atol = rtol = 1e-5); frames of equal length side by side, apart
and of mixed lengths; the frame runs read from the ids; bf16 inputs in the
activation dtype. A CUDA case (tests/test_torch_cuda.py) holds the card's
SDPA path to this one."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu_torch.ops.packed_attention import frame_runs, segment_attention

jpa = importlib.import_module("dsocr_tpu.ops.packed_attention")

F32 = dict(atol=1e-5, rtol=1e-5)
LAYOUTS = {
    "one": [40],
    "equal_adjacent": [16, 16, 16],
    "mixed": [12, 30, 12, 7],
    "equal_apart": [20, 9, 20, 9, 20],
}


def _qkv(n, heads=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, heads, d)).astype(np.float32) for _ in range(3)]


def _seg(lengths):
    return np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chunks", [(1024, 1024), (8, 8), (13, 5)])
def test_segment_attention_equals_reference(layout, chunks):
    lengths = LAYOUTS[layout]
    seg = _seg(lengths)
    q, k, v = _qkv(len(seg), seed=len(lengths))
    want = jpa.segment_attention(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(seg), *chunks)
    got = segment_attention(*(torch.from_numpy(t) for t in (q, k, v)), seg)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_segment_attention_takes_ids_as_a_list_array_or_cpu_tensor():
    seg = _seg([5, 11])
    q, k, v = (torch.from_numpy(t) for t in _qkv(16, seed=4))
    want = segment_attention(q, k, v, seg)
    for form in (torch.from_numpy(seg), seg.tolist()):
        assert torch.equal(segment_attention(q, k, v, form), want)


def test_segment_attention_bf16_in_the_activation_dtype():
    seg = _seg([24, 10])
    q, k, v = _qkv(34, seed=6)
    want = jpa.segment_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(seg))
    got = segment_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), seg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


def test_frame_runs():
    assert frame_runs(_seg([3, 1, 4])) == [(0, 3), (3, 1), (4, 4)]
    assert frame_runs([]) == []
    assert frame_runs(np.array([7, 7, 2, 2, 2])) == [(0, 2), (2, 3)]
    with pytest.raises(ValueError, match="contiguous"):
        frame_runs([0, 0, 1, 1, 0])
    q = torch.zeros(4, 1, 8)
    with pytest.raises(ValueError, match="cover"):
        segment_attention(q, q, q, [0, 0, 1])
