"""The launch plans of K3 (flash decode) and K7 (w4a16), as pure functions.

They run here: the plans are Python, only the kernels they size need the
card. K7's `plan_w4` cuts the contracting axis into splits of whole stages
and each split into the 4 warps' runs; K3's `decode_plan` picks the split
count and `split_tiles` is the kernel's cut of a unit's valid tiles into
splits and warps' runs (the kernel finds the unit's first and last valid
slot itself, by the scan this file mirrors in `_unit_tiles`).
"""

import numpy as np
import pytest

from gritlm_tpu_torch.ops import decode_attention as da
from gritlm_tpu_torch.ops import quant_matmul as qm

# Mistral-7B's projections (K, N), and a column count off the 128-column tiles
W4_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000),
             (4096, 1040)]


def _runs(n, parts):
    return [da.split_tiles(n, s, parts) for s in range(parts)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("K,N", W4_SHAPES)
def test_w4_plan_covers_every_stage(K, N, sms):
    """At every row count the kernel takes (1-128): 8 or 16 rows a block,
    every contracting stage in exactly one split and one warp's run, whole
    stages, no split without a stage, at most MAX_SPLITS (the partials
    [splits, M, N])."""
    Kp = K // 2
    stages = Kp // qm.W4_STAGE
    assert stages * qm.W4_STAGE == Kp  # whole stages: the group divides K/2
    for M in range(1, qm.MAX_KERNEL_ROWS + 1):
        bm, splits, kper = qm.plan_w4(M, Kp, N, sms)
        assert bm == (8 if M <= 8 else 16)
        assert 1 <= splits <= qm.MAX_SPLITS
        seen = np.zeros(stages, dtype=int)
        for z in range(splits):
            s0, s1 = z * kper, min(stages, (z + 1) * kper)
            assert s1 > s0, (M, z)  # no split past the contracting axis
            for w0, w1 in _runs(s1 - s0, qm.W4_WARPS):  # the warps' runs, as the kernel cuts them
                seen[s0 + w0:s0 + w1] += 1
        assert (seen == 1).all(), M


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("K,N", W4_SHAPES[:5])
def test_w4_plan_fills_the_card_at_decode(K, N, sms):
    """The split count: about two blocks an SM over the column tiles, each
    warp two stages or more, so the fix-up's partial sums stay few; the
    measured best on the card at M 8 (wk/wv 16, wq/wo and down 8, gate/up
    2, the head 1)."""
    Kp = K // 2
    stages = Kp // qm.W4_STAGE
    col_tiles = -(-N // qm.BN)
    for M in (1, 2, 8, 16, 64, 128):
        bm, splits, kper = qm.plan_w4(M, Kp, N, sms)
        assert col_tiles * splits <= max(col_tiles, qm.W4_SPLIT_BLOCKS_PER_SM * sms)
        assert splits == 1 or -(-kper // qm.W4_WARPS) >= qm.W4_MIN_STAGES
        if sms == 132:
            best = {1024: 16, 4096: 8, 14336: 2, 32000: 1}[N]
            assert splits == best, (M, splits)


def _unit_tiles(mask_row, lo, hi):
    """The kernel's scan: (first tile, tile count) of the valid slots in
    [lo, hi) of one mask row; (0, 0) when there is none."""
    valid = np.flatnonzero(mask_row[lo:hi]) + lo if hi > lo else np.zeros(0, int)
    if valid.size == 0:
        return 0, 0
    t0 = valid[0] // da.SLOT_TILE
    return t0, valid[-1] // da.SLOT_TILE + 1 - t0


# (B, Sq, H, Hkv, Smax, causal, offset, window): generate's decode and short
# prefills, the serving chunk (mask-bounded), GQA groups 1, 4, 8, windows
DECODE_SHAPES = [
    (4, 1, 32, 8, 2048, True, 1499, None),
    (4, 64, 32, 8, 2048, True, 1436, None),
    (8, 1, 32, 8, 4096, False, 0, None),
    (2, 7, 8, 8, 512, True, 290, None),
    (2, 7, 8, 1, 512, True, 300, 64),
    (3, 3, 8, 2, 512, True, 250, 64),
    (1, 127, 32, 8, 333, True, 200, None),
    (2, 1, 32, 4, 97, False, 0, 16),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("B,Sq,H,Hkv,Smax,causal,offset,window", DECODE_SHAPES)
def test_decode_plan_covers_the_valid_slots(B, Sq, H, Hkv, Smax, causal, offset, window, sms,
                                            quant):
    """Every slot that can hold a key for a unit's rows (valid in the mask,
    under the causal bound, inside the window) falls in exactly one split
    and one warp's run; splits are whole 16-slot tiles inside the unit's
    valid range (none lies past it); the splits a unit uses are at most the
    launch's, each with tiles for every warp when there are several (so
    each leaves a partial); the split count stays within the partial
    buffers."""
    n_split, n_rg = da.decode_plan(B, Sq, H, Hkv, Smax, sms, causal=causal, offset=offset,
                                   window=window, quant=quant)
    group = H // Hkv
    R = Sq * group
    units = B * Hkv * n_rg
    assert n_rg * da.ROW_GROUP >= R > (n_rg - 1) * da.ROW_GROUP
    assert 1 <= n_split <= da.MAX_SPLITS
    assert n_split * units <= max(units, da.BLOCKS_PER_SM[quant] * sms)  # one wave, or one split
    part_ml, part_o = da.partials(n_split, units, "cpu")
    if n_split == 1:
        assert part_ml is None and part_o is None
    else:
        assert tuple(part_ml.shape) == (n_split, units, da.ROW_GROUP, 2)
        assert tuple(part_o.shape) == (n_split, units, da.ROW_GROUP, 128)
    rng = np.random.default_rng(Smax + Sq)
    lengths = [0, 1, 31, 33, Smax][:B] + list(rng.integers(1, Smax + 1, size=max(0, B - 5)))
    for b in range(B):
        row = np.zeros(Smax, dtype=np.int32)
        row[:lengths[b]] = 1
        row[(rng.random(Smax) < 0.2)] = 0  # holes
        for rg in range(n_rg):
            r0, r1 = rg * da.ROW_GROUP, min(R, (rg + 1) * da.ROW_GROUP) - 1
            lo, hi = da.slot_range(r0 // group, r1 // group, Smax, causal=causal,
                                   offset=offset, window=window)
            if causal:
                assert hi <= offset + Sq
            t0, nt = _unit_tiles(row, lo, hi)
            n_used = da.used_splits(nt, n_split)
            assert 1 <= n_used <= n_split
            owner = np.zeros(Smax, dtype=int)
            for s in range(n_used):
                a, e = da.split_tiles(nt, s, n_used)
                assert 0 <= a <= e <= nt
                if n_used > 1:  # every used split has its tiles: it leaves a partial
                    assert e - a >= da.DECODE_WARPS * da.MIN_TILES_PER_WARP
                for w0, w1 in _runs(e - a, da.DECODE_WARPS):
                    owner[(t0 + a + w0) * da.SLOT_TILE:(t0 + a + w1) * da.SLOT_TILE] += 1
            visible = np.zeros(Smax, dtype=bool)
            visible[lo:hi] = row[lo:hi] != 0
            assert (owner[visible] == 1).all(), (b, rg)
            assert owner.max(initial=0) <= 1
            if nt:  # the splits' tiles lie between the first and the last valid slot's tiles
                first, last = np.flatnonzero(visible)[[0, -1]]
                covered = np.flatnonzero(owner)
                assert covered[0] == (first // da.SLOT_TILE) * da.SLOT_TILE
                assert covered[-1] == (last // da.SLOT_TILE) * da.SLOT_TILE + da.SLOT_TILE - 1
            else:
                assert not owner.any()


@pytest.mark.parametrize("n,parts", [(0, 4), (1, 4), (3, 4), (94, 8), (256, 32), (17, 5)])
def test_split_tiles_cut_in_order(n, parts):
    """Parts are contiguous, in order, cover 0..n exactly and differ in size
    by at most one tile."""
    runs = _runs(n, parts)
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(runs[i][1] == runs[i + 1][0] for i in range(parts - 1))
    sizes = [e - a for a, e in runs]
    assert max(sizes) - min(sizes) <= 1


def test_decode_plan_bounds_the_range_on_the_host():
    """The host's plan sees the causal bound: a decode step at offset 1499
    of a 2048-slot cache plans over 94 tiles, not the 128 of Smax, and a
    mask-bounded call over Smax; more units take fewer splits."""
    n1, _ = da.decode_plan(4, 1, 32, 8, 2048, 132, causal=True, offset=1499)
    n2, _ = da.decode_plan(4, 1, 32, 8, 2048, 132, causal=True, offset=15)
    assert n2 < n1 <= da.MAX_SPLITS
    assert n2 == -(-da.slot_range(0, 0, 2048, causal=True, offset=15, window=None)[1]
                   // (da.SLOT_TILE * da.DECODE_WARPS * da.MIN_TILES_PER_WARP))
    n_serv, n_rg = da.decode_plan(8, 1, 32, 8, 4096, 132, causal=False)
    assert n_rg == 1 and n_serv == da.BLOCKS_PER_SM[False] * 132 // 64
    n_pref, n_rg = da.decode_plan(4, 64, 32, 8, 2048, 132, causal=True, offset=1436)
    assert n_rg == 32 and n_pref == 1
