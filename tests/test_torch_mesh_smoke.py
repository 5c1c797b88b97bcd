"""chip_smoke.py's mesh checks, on the CPU.

The mesh phase holds each case's tokens to the single-process engine's
on the same seeded weights. A token may differ only at a greedy
near-tie: where the single-process top-2 margin is below
MESH_LOGIT_TOL. The seed must be clear of near-ties, or a fault that
moves the mesh's logits by less than the tolerance could pass; the
full-width margins exist only on the card, so the smoke reads them on
every run and fails a case whose least margin is not above the
tolerance (mesh_seed_margin). These tests pin the two checks and the
tolerance against what the card read: prefill logits within 0.0324 of
the single-process engine's, and case (a)'s least margin 0.1033
(NVIDIA H100 80GB HBM3, 700 W).
"""

import pytest

import chip_smoke

CARD_PREFILL_DIFF = 0.0324  # the mesh's largest prefill-logit difference on the card
CARD_LEAST_MARGIN_A = 0.1033  # case (a)'s least single-process top-2 margin on the card


def test_tolerance_sits_between_the_card_drift_and_the_seed_margin():
    assert CARD_PREFILL_DIFF < chip_smoke.MESH_LOGIT_TOL < CARD_LEAST_MARGIN_A


@pytest.mark.parametrize("margins,least,step,clear", [
    ([0.29, 0.25, 0.1033, 0.16], 0.1033, 2, True),
    ([0.29, 0.05, 0.16], 0.05, 1, False),
    ([0.0625], 0.0625, 0, False),  # at the tolerance is not clear of it
])
def test_seed_margin_gate(margins, least, step, clear):
    assert chip_smoke.mesh_seed_margin(margins) == (least, step)
    assert (least > chip_smoke.MESH_LOGIT_TOL) == clear


@pytest.mark.parametrize("got,ok,first,margin", [
    ([[5, 6, 7, 8]] * 2, True, None, None),
    ([[5, 6, 7, 8], [5, 9, 7, 8]], False, 1, 0.2),  # differs where the margin is clear: a fault
    ([[5, 6, 7, 8], [5, 6, 9, 8]], True, 2, 0.03),  # differs at a near-tie
    ([[5, 6, 7, 8], [5]], False, 1, 0.2),  # stops early (an EOS) where the margin is clear
])
def test_mesh_parity(got, ok, first, margin):
    ref = dict(tokens=[[5, 6, 7, 8]] * 2, margins=[0.3, 0.2, 0.03, 0.25])
    fields, passed = chip_smoke.mesh_parity(ref, got)
    assert passed == ok
    assert fields["tokens_equal_single_process"] == (first is None)
    assert fields.get("first_differing_step") == first
    assert fields.get("single_process_top2_margin") == margin
