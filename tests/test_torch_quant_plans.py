"""The launch plans of the redesigned K9-K12 kernels, on the CPU: K9's
``io`` decode-row split of the contraction axis over a cluster
(``qmatmul.io_rows_plan``), K10's split of the packed axis on group
boundaries (``qmatmul.io4_rows_plan``) and the thread-block clusters of
K12 and K11 (``cross_attention.cluster_plan``, ``wide_cluster_plan``).  A
plan must depend only on shapes and the SM count, cover every weight row,
byte row or slot exactly once, and never hand a cluster or a CTA more than
the kernel takes."""

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


# K10: (s, o) at the int4 decode step's widths (s a multiple of the group)
SHAPES4 = [(384, 384), (384, 1152), (384, 1536), (1536, 384),   # tiny.en
           (1280, 1280), (1280, 3840), (1280, 5120), (5120, 1280),  # large
           (128, 200), (5120, 200), (2048, 1104), (51200, 384)]


@pytest.mark.parametrize("n_sms", [132, 16])
@pytest.mark.parametrize("s,o,group", [(s, o, g) for s, o in SHAPES4
                                       for g in (128, 64, 256)
                                       if s % g == 0])
def test_io4_rows_plan_cuts_only_on_group_boundaries(s, o, group, n_sms):
    """Slices tile the s / 2 packed byte rows without gap or overlap, none
    empty, at most 8; every slice boundary is a group boundary (a multiple
    of group / 2 byte rows), so no group's partial product is split before
    it is scaled.  Up to 512 byte rows a CTA takes the whole axis; beyond,
    a power of two of slices as far as one wave of CTAs allows."""
    sl, n_split = Q.io4_rows_plan(5, s, o, group, n_sms)
    h, hg = s // 2, group // 2
    assert sl % hg == 0 and 1 <= n_split <= Q.MAX_SPLIT
    bounds = [(i * sl, min((i + 1) * sl, h)) for i in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    assert all(a % hg == 0 for a, _ in bounds)
    n_tiles = -(-o // Q.ROW_TILE)
    if h <= Q.MAX_WHOLE:
        assert n_split == 1
    else:
        assert n_split == 1 or n_tiles * n_split <= n_sms
        cap = max(1, min(Q.MAX_SPLIT, -(-h // Q.ROWS_PER_PASS),
                         n_sms // n_tiles))
        want = 1 << (cap.bit_length() - 1)
        # rounding slices up to whole groups may drop slices
        assert n_split <= want and -(-h // n_split) <= sl


@pytest.mark.parametrize("s,o", SHAPES4)
def test_io4_rows_plan_depends_on_shapes_and_sms_only(s, o):
    """The same plan at every row count the kernel takes (1..16)."""
    params = list(inspect.signature(Q.io4_rows_plan).parameters)
    assert params == ["m", "s", "o", "group", "n_sms"]
    plans = {Q.io4_rows_plan(m, s, o, 128) for m in range(1, Q.ROWS_MAX + 1)}
    assert plans == {Q.io4_rows_plan(5, s, o, 128, 132)}


def test_io4_rows_plan_splits_the_long_axes():
    """tiny.en's mlp.w1 (768 byte rows) in two slices of 6 groups; a 5120
    axis at a narrow width in 8; large-v3 widths fill a wave unsplit."""
    assert Q.io4_rows_plan(5, 1536, 384, 128) == (384, 2)
    assert Q.io4_rows_plan(5, 5120, 200, 128) == (320, 8)
    assert Q.io4_rows_plan(8, 5120, 1280, 128) == (2560, 1)
    assert Q.io4_rows_plan(5, 384, 1536, 128) == (192, 1)


@pytest.mark.parametrize("m,s,group", [(0, 384, 128), (17, 384, 128),
                                       (1500, 384, 128), (5, 384, 96),
                                       (5, 320, 128), (5, 384, 32)])
def test_io4_rows_plan_refuses_what_the_kernel_does_not_take(m, s, group):
    with pytest.raises(ValueError):
        Q.io4_rows_plan(m, s, 384, group)


@pytest.mark.parametrize("kv_group", [7, 8])
@pytest.mark.parametrize("t_pad", [256, 768, 1536])
def test_wide_cluster_plan_covers_each_256_slot_block_once(t_pad, kv_group):
    """K11 (20 heads x kv_group 7 and 8 > 128 lanes): 4 CTAs of 64 slots
    tile each 256-slot softmax block once, whatever T; the grid is (4, 20,
    groups), so one large-v3 stream at beam 8 runs 80 CTAs."""
    assert not CA.is_packed(20, kv_group)
    sl, nc = CA.wide_cluster_plan(1, 20, t_pad)
    assert (sl, nc) == (CA.CLUSTER_SLICE, 4)
    blk = CA.softmax_block(t_pad, False)
    assert blk == 256 == sl * nc
    for b in range(t_pad // blk):
        slots = [b * blk + r * sl + j for r in range(nc) for j in range(sl)]
        assert slots == list(range(b * blk, (b + 1) * blk))
    assert nc * 20 * 1 == 80
    assert CA.wide_cluster_plan(3, 20, t_pad) == (sl, nc)
    assert list(inspect.signature(CA.wide_cluster_plan).parameters) == [
        "g", "n_head", "t_pad"]


@pytest.mark.parametrize("args", [(0, 20, 1536), (1, 0, 1536),
                                  (1, 20, 1000), (1, 129, 1536)])
def test_wide_cluster_plan_refuses_shapes_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        CA.wide_cluster_plan(*args)
