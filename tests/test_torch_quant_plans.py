"""The launch plans of the redesigned K9 and K12 kernels, on the CPU: K9's
``io`` decode-row split of the contraction axis over a cluster
(``qmatmul.io_rows_plan``) and K12's thread-block cluster
(``cross_attention.cluster_plan``).  A plan must depend only on shapes and
the SM count, cover every weight row or slot exactly once, and never hand a
cluster or a CTA more than the kernel takes."""

import inspect

import pytest

from godot_whisper_tpu_torch.ops import cross_attention as CA
from godot_whisper_tpu_torch.ops import qmatmul as Q

SHAPES = [(384, 384), (384, 1152), (384, 1536), (1536, 384),  # tiny.en step
          (1280, 1280), (1280, 3840), (5120, 1280),           # large-v3
          (1000, 200), (2080, 1104), (96, 200), (1, 16), (51864, 384)]


@pytest.mark.parametrize("n_sms", [132, 114, 16, 1])
@pytest.mark.parametrize("s,o", SHAPES)
def test_io_rows_plan_covers_every_row_once(s, o, n_sms):
    """Slices (a multiple of 8 rows) tile [0, s) without gap or overlap,
    none empty, at most 8 of them (the cluster that adds them up).  Up to
    512 rows a CTA takes the whole axis; beyond, the cut fills one wave of
    CTAs as far as 8 slices of at least one pass allow."""
    sl, n_split = Q.io_rows_plan(5, s, o, n_sms)
    assert sl % 8 == 0
    assert 1 <= n_split <= Q.MAX_SPLIT
    bounds = [(i * sl, min((i + 1) * sl, s)) for i in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    n_tiles = -(-o // Q.ROW_TILE)
    passes = -(-s // Q.ROWS_PER_PASS)
    if s <= Q.MAX_WHOLE:
        assert n_split == 1
    else:
        # one wave (a CTA a SM) unless the tiles alone exceed it; rounding
        # slices to 8 rows may drop one slice a tile
        assert n_split == 1 or n_tiles * n_split <= n_sms
        cap = max(1, min(Q.MAX_SPLIT, passes, n_sms // n_tiles))
        want = 1 << (cap.bit_length() - 1)  # a power of two
        assert n_split in (want, want - 1)


@pytest.mark.parametrize("s,o", SHAPES)
def test_io_rows_plan_depends_on_shapes_and_sms_only(s, o):
    """The same plan for every row count the kernel takes (1..16) and on
    every call: no tensor enters it, so the grid cannot follow data."""
    params = list(inspect.signature(Q.io_rows_plan).parameters)
    assert params == ["m", "s", "o", "n_sms"]
    plans = {Q.io_rows_plan(m, s, o, 132) for m in range(1, Q.ROWS_MAX + 1)}
    assert plans == {Q.io_rows_plan(5, s, o)}
    assert Q.io_rows_plan(5, s, o, 132) == Q.io_rows_plan(5, s, o, 132)


@pytest.mark.parametrize("m", [0, 17, 1500])
def test_io_rows_plan_refuses_rows_the_kernel_does_not_take(m):
    with pytest.raises(ValueError):
        Q.io_rows_plan(m, 384, 384)


@pytest.mark.parametrize("g", [1, 5, 16])
@pytest.mark.parametrize("t_pad", [256, 512, 768, 1536, 2048])
def test_cluster_plan_covers_each_softmax_block_once(t_pad, g):
    """A cluster's CTAs take 64-slot slices that tile each softmax block
    (512 slots, 256 when T % 512 != 0) exactly once, in a portable cluster
    of at most 8; only shapes decide (the valid lengths never enter)."""
    sl, nc = CA.cluster_plan(g, 6, t_pad)
    blk = CA.softmax_block(t_pad, True)
    assert sl == CA.CLUSTER_SLICE == 64
    assert nc * sl == blk and 1 <= nc <= CA.MAX_CLUSTER
    slots = [c for r in range(nc) for c in range(r * sl, (r + 1) * sl)]
    assert slots == list(range(blk))
    assert (sl, nc) == CA.cluster_plan(1, 20, t_pad)
    assert list(inspect.signature(CA.cluster_plan).parameters) == [
        "g", "n_head", "t_pad"]


@pytest.mark.parametrize("args", [(0, 6, 1536), (1, 0, 1536), (1, 6, 1000)])
def test_cluster_plan_refuses_shapes_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        CA.cluster_plan(*args)
