"""The launch plans of K3 (flash decode), K8 (paged decode), K6 (w8a16), K7
(w4a16) and K2 (the encode epilogue), as pure functions.

They run here: the plans are Python, only the kernels they size need the
card. K6's and K7's rows kernels (`plan_w8` at decode rows, `plan_w4`) cut
the contracting axis into splits of whole stages and each split into the 4
warps' runs; K6's staged template (`plan_w8` above W8_ROWS_MAX rows) walks
whole stages a split. K3's `decode_plan` picks the split count and
`split_tiles` is the kernel's cut of a unit's valid tiles into splits and
warps' runs (the kernel finds the unit's first and last valid slot itself,
by the scan this file mirrors in `_unit_tiles`); K8 plans with the same
functions (`paged_plan`) and reads each 16-slot tile through one page-table
entry. K2's `pool_plan` gives each batch row C blocks in clusters of CL;
the kernel splits the row's masked-in rows among them by rank, as
`_pool_split` mirrors.
"""

import numpy as np
import pytest
import torch

from gritlm_tpu_torch.ops import decode_attention as da
from gritlm_tpu_torch.ops import fused_pool as fp
from gritlm_tpu_torch.ops import paged_attention as pa
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
            for w0, w1 in _runs(s1 - s0, qm.ROWS_WARPS):  # the warps' runs, as the kernel cuts them
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
        assert splits == 1 or -(-kper // qm.ROWS_WARPS) >= qm.ROWS_MIN_STAGES
        if sms == 132:
            best = {1024: 16, 4096: 8, 14336: 2, 32000: 1}[N]
            assert splits == best, (M, splits)


# K6's shapes: Mistral-7B's projections, a column count off the 128-column
# tiles and a contracting axis off the 32-row stages (K % 32 == 16)
W8_SHAPES = W4_SHAPES + [(4112, 1040)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("K,N", W8_SHAPES)
def test_w8_plan_covers_every_stage(K, N, sms):
    """At every row count K6 takes (1-512): the rows kernel (8 or 16 rows a
    block, stages of W8_STAGE rows, the last one short when 32 does not
    divide K) up to W8_ROWS_MAX rows, every stage in exactly one split and
    one warp's run; the staged template (BM rows a block, stages of DK rows)
    above, every stage in exactly one split; no split without a stage, at
    most MAX_SPLITS (the partials [splits, M, N])."""
    for M in range(1, qm.MAX_KERNEL_ROWS8 + 1):
        bm, splits, kper = qm.plan_w8(M, K, N, sms)
        rows = M <= qm.W8_ROWS_MAX
        assert bm == ((8 if M <= 8 else 16) if rows else qm.BM)
        stages = -(-K // (qm.W8_STAGE if rows else qm.DK))
        assert 1 <= splits <= qm.MAX_SPLITS
        seen = np.zeros(stages, dtype=int)
        for z in range(splits):
            s0, s1 = z * kper, min(stages, (z + 1) * kper)
            assert s1 > s0, (M, z)  # no split past the contracting axis
            for w0, w1 in (_runs(s1 - s0, qm.ROWS_WARPS) if rows else [(0, s1 - s0)]):
                seen[s0 + w0:s0 + w1] += 1
        assert (seen == 1).all(), M


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("K,N", W4_SHAPES[:5])
def test_w8_plan_fills_the_card_at_decode(K, N, sms):
    """K6's rows kernel splits by K7's rule with one block an SM over the
    column tiles instead of two (a K6 stage carries twice K7's weight
    bytes), each warp two stages or more; at 132 SMs the split counts K6
    measured best at M 8 (wq/wo and down 4, gate/up and the head 1; wk/wv 16,
    within 2% of its best 8)."""
    stages = -(-K // qm.W8_STAGE)
    col_tiles = -(-N // qm.BN)
    for M in (1, 2, 8, 9, 16, 17, 64):
        bm, splits, kper = qm.plan_w8(M, K, N, sms)
        assert col_tiles * splits <= max(col_tiles, qm.W8_SPLIT_BLOCKS_PER_SM * sms)
        assert splits == 1 or -(-kper // qm.ROWS_WARPS) >= qm.ROWS_MIN_STAGES
        if sms == 132:
            best = {1024: 16, 4096: 4, 14336: 1, 32000: 1}[N]
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
@pytest.mark.parametrize("head_dim", [64, 96, 128])
@pytest.mark.parametrize("B,Sq,H,Hkv,Smax", [(4, 1, 32, 8, 2048), (8, 8, 14, 2, 4096),
                                             (8, 1, 16, 8, 4096)])
def test_decode_plan_at_head_dims(B, Sq, H, Hkv, Smax, head_dim, quant):
    """The K3/K8 plan at head dims 64, 96 and 128: the blocks an SM holds
    follow the rings' shared memory (4 warps x 3 stages x K and V x 16 rows
    of Dh elements padded by 16 bytes), at most 4; Dh 128 keeps its 2 / 4
    blocks (bf16 / int8); one wave or one split; the partials' rows are Dh
    wide."""
    ring = da.ring_bytes(head_dim, quant)
    assert ring == 4 * 3 * 2 * 16 * (head_dim * (1 if quant else 2) + 16)
    blocks = da.blocks_per_sm(quant, head_dim)
    assert 1 <= blocks <= da.MAX_BLOCKS_PER_SM and blocks * ring <= da.SMEM_PER_SM
    assert blocks == da.MAX_BLOCKS_PER_SM or (blocks + 1) * ring > da.SMEM_PER_SM
    if head_dim == 128:
        assert blocks == da.BLOCKS_PER_SM[quant] == (4 if quant else 2)
    n_split, n_rg = da.decode_plan(B, Sq, H, Hkv, Smax, 132, causal=False, quant=quant,
                                   head_dim=head_dim)
    units = B * Hkv * n_rg
    assert n_rg == -(-Sq * (H // Hkv) // da.ROW_GROUP)
    assert n_split * units <= max(units, blocks * 132)
    assert (n_split, n_rg) == pa.paged_plan(B, Sq, H, Hkv, Smax, 132, causal=False, offset=0,
                                            quant=quant, head_dim=head_dim)
    part_ml, part_o = da.partials(max(n_split, 2), units, "cpu", head_dim)
    assert tuple(part_o.shape) == (max(n_split, 2), units, da.ROW_GROUP, head_dim)


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


# (Sq, page, causal): the serving decode step (mask-bounded) and the
# speculative verify chunk (causal at per-row offsets), pages of 32 to 512
PAGED_SHAPES = [(1, 256, False), (1, 32, False), (8, 256, True), (8, 32, True),
                (7, 64, True), (64, 512, True), (1, 128, True)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("Sq,page,causal", PAGED_SHAPES)
def test_paged_plan_covers_the_visible_slots(Sq, page, causal, sms, quant):
    """K8 over a shuffled page pool (a page shared by two rows, an empty row,
    a hole, rows up to the full logical width), per-row offsets: every
    logical slot that a unit's rows can see (valid in the mask, at most
    offset[b] + the row's query position when causal) falls in exactly one
    split and one warp's run; no split lies past the row's valid range; and
    each 16-slot tile lies in one page, so the kernel's one page-table read
    a tile (page_table[b, 16 t // page], slot 16 t % page) addresses each of
    its slots where the plain version's gather finds it."""
    B, H, Hkv, maxp = 6, 32, 8, 4096 // page
    Smax = maxp * page
    rng = np.random.default_rng(page + Sq)
    P = B * maxp + 1
    table = (rng.permutation(P - 1)[:B * maxp] + 1).reshape(B, maxp)
    table[4, 0] = table[3, 0]  # a prefix page shared by two rows
    lens = np.array([0, 1, page - 1, page + 17, Smax, 1900])
    mask = (np.arange(Smax)[None] < lens[:, None]).astype(np.int32)
    mask[5, 600:700] = 0  # a hole
    offsets = np.maximum(lens - Sq, 0)
    n_split, n_rg = pa.paged_plan(B, Sq, H, Hkv, Smax, sms, causal=causal,
                                  offset=torch.tensor(offsets), quant=quant)
    assert (n_split, n_rg) == da.decode_plan(B, Sq, H, Hkv, Smax, sms, causal=False,
                                             quant=quant)  # per-row offsets: the host plans over Smax
    group = H // Hkv
    R = Sq * group
    for b in range(B):
        for rg in range(n_rg):
            r0, r1 = rg * da.ROW_GROUP, min(R, (rg + 1) * da.ROW_GROUP) - 1
            lo, hi = da.slot_range(r0 // group, r1 // group, Smax, causal=causal,
                                   offset=int(offsets[b]), window=None)
            t0, nt = _unit_tiles(mask[b], lo, hi)
            n_used = da.used_splits(nt, n_split)
            owner = np.zeros(Smax, dtype=int)
            for s in range(n_used):
                a, e = da.split_tiles(nt, s, n_used)
                for w0, w1 in _runs(e - a, da.DECODE_WARPS):
                    for tile in range(t0 + a + w0, t0 + a + w1):
                        slots = tile * da.SLOT_TILE + np.arange(da.SLOT_TILE)
                        owner[slots] += 1
                        assert (slots // page == slots[0] // page).all()  # one page a tile
                        first = table[b, slots[0] // page] * page + slots[0] % page
                        assert (first + np.arange(da.SLOT_TILE)
                                == table[b, slots // page] * page + slots % page).all()
            visible = np.zeros(Smax, dtype=bool)
            visible[lo:hi] = mask[b, lo:hi] != 0
            assert (owner[visible] == 1).all(), (b, rg)
            assert owner.max(initial=0) <= 1
            if not visible.any():
                assert not owner.any()


def test_paged_plan_takes_the_host_bound_of_one_offset():
    """One int offset for every row bounds the plan on the host as K3's
    does; a tensor of per-row offsets leaves the bound to the kernel."""
    one = pa.paged_plan(4, 1, 32, 8, 4096, 132, causal=True, offset=15, quant=False)
    assert one == da.decode_plan(4, 1, 32, 8, 4096, 132, causal=True, offset=15)
    rows = pa.paged_plan(4, 1, 32, 8, 4096, 132, causal=True, offset=torch.tensor([15] * 4),
                         quant=False)
    assert rows == da.decode_plan(4, 1, 32, 8, 4096, 132, causal=False)
    assert one[0] < rows[0]


# ------------------------------------------------------------------ K2

POOL_B = [1, 2, 3, 8, 64, 132, 264, 1000]
POOL_S = [1, 3, 64, 128, 512, 700, 4096, 32768, 1 << 19]


def _pool_fit(cl, balanced):
    """Co-resident clusters of an H100 at the kernel's two blocks an SM
    (cudaOccupancyMaxActiveClusters read on the card)."""
    return {16: 14, 8: 30, 4: 62, 2: 132, 1: 264}[cl]


@pytest.mark.parametrize("fit", [None, _pool_fit], ids=["no fit", "fit"])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("B", POOL_B)
def test_pool_plan_fills_the_card_and_bounds_the_list(B, sms, fit):
    """Every row gets `need` clusters, enough that no block takes more than
    MAX_LIST rows; about two blocks an SM over the batch (at least one an
    SM where the rows allow it), no more than one wave of clusters where the
    rows allow it; balanced only over a mask every block can read and with
    clusters to apportion."""
    for S in POOL_S:
        K, CL, need, balanced = fp.pool_plan(B, S, sms, fit=fit)
        assert CL in fp.CLUSTERS and need >= 1 and K >= B * need, (S, K, CL, need)
        assert need * CL * fp.MAX_LIST >= S, (S, need, CL)
        if K > B * need:
            assert K * CL <= fp.BLOCKS_PER_SM * sms, (S, K, CL)
            if fit is not None:
                assert K <= fit(CL, balanced), (S, K, CL)
        if balanced:
            assert B > 1 and B * S <= fp.BALANCE_MAX and K > B * need
        if B <= sms and S * B >= 2 * sms * fp.MIN_ROWS and fit is None:
            assert K * CL >= sms, (S, K, CL)


def test_pool_plan_at_the_encode_shapes():
    """On 132 SMs with the H100's co-resident clusters: the kernel table's
    B 8 S 512 as 30 clusters of 8 apportioned by the rows' counts; one row of
    4096 over 30 clusters; B 64 S 128 in clusters of 2 (64 clusters of 4 do
    not fit at once), 132 of them apportioned; B 8 S 64 one cluster of 8 a
    row (finished in the cluster)."""
    assert fp.pool_plan(8, 512, 132, fit=_pool_fit) == (30, 8, 1, True)
    assert fp.pool_plan(1, 4096, 132, fit=_pool_fit) == (30, 8, 1, False)
    assert fp.pool_plan(64, 128, 132, fit=_pool_fit) == (132, 2, 1, True)
    assert fp.pool_plan(8, 64, 132, fit=_pool_fit) == (8, 8, 1, False)


def _pool_rows(K: int, need: int, counts) -> list:
    """The first cluster of each row, then K: the kernel's apportionment
    (`first_cluster` in csrc/fused_pool.cu) for the rows' masked-in counts
    (all zero: equal shares)."""
    B, R = len(counts), int(sum(counts))
    extra, firsts, P = K - B * need, [], 0
    for b, n in enumerate(counts):
        firsts.append(b * need + (extra * P // R if R else extra * b // B))
        P += int(n)
    return firsts + [K]


def _pool_split(row_mask, C):
    """The kernel's split of one row over its C blocks: block c takes the
    masked-in positions of ranks [R c / C, R (c + 1) / C), rank = the mask
    tokens before the position (its weightedmean weight is rank + 1)."""
    pos = np.flatnonzero(row_mask)
    R = len(pos)
    return [pos[R * c // C: R * (c + 1) // C] for c in range(C)]


@pytest.mark.parametrize("B,S", [(8, 512), (1, 4096), (64, 128), (3, 700), (8, 64), (5, 40)])
def test_pool_split_takes_each_masked_row_once(B, S):
    """The clusters tile [0, K) row by row, each row `need` or more; every
    masked-in position in exactly one block's list, none masked out, at
    most MAX_LIST a block, the shares even within a row, in position order
    (each block's weights are consecutive ranks); apportioned by the
    counts, no block of a full row takes twice the blocks' mean (plus one)."""
    rng = np.random.default_rng(S)
    K, CL, need, balanced = fp.pool_plan(B, S, 132, fit=_pool_fit)
    masks = [rng.random(S) < rng.choice([0.0, 0.3, 0.9, 1.0]) for _ in range(B)]
    counts = [int(m.sum()) for m in masks]
    firsts = _pool_rows(K, need, counts if balanced else [0] * B)
    assert firsts[0] == 0 and firsts[-1] == K
    sizes = []
    for b, mask in enumerate(masks):
        assert firsts[b + 1] - firsts[b] >= need
        parts = _pool_split(mask, (firsts[b + 1] - firsts[b]) * CL)
        np.testing.assert_array_equal(np.concatenate(parts), np.flatnonzero(mask))
        row = [len(p) for p in parts]
        assert max(row) <= fp.MAX_LIST and max(row) - min(row) <= 1
        sizes += row
    if balanced:
        assert max(sizes) <= 2 * sum(counts) / (K * CL) + 1, (max(sizes), sum(counts), K * CL)
