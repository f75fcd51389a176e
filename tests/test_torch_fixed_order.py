"""The host side of the sweep kernels' fixed-order sums, on the CPU.

Every sweep kernel of the port writes per-block partials and sums them in
an order fixed by the rows and the host plan (``ops/block_sum.py``,
``csrc/block_sum.cu``), and where a sweep writes marginal streams, sums
them along a gene-sorted plan (``ops/em_bd.py::plan_scatter``).  The
kernels run only on the card; here the host plans are held to the sizes
the CUDA sources use, the plan built on the card
(``ops/em_large_g.py::device_scatter_plan``) to the reference's host plan,
and K4's piece fix-up and the in-block key sum (``csrc/em_bdg.cu``,
``csrc/em_tile.cuh::keyed_sum``, round by round and lane by lane) run as
host loops against a direct sum.  Sums of float64 values in two orders
agree to 1e-12; the key sum's float32 models are held to equal bits.
"""

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu_torch.ops import (
    block_sum,
    em_bdg,
    em_bdr,
    em_large_g,
    em_large_k,
    em_rsorted,
)

torch.set_num_threads(2)

H100_SMS = 132


@pytest.mark.parametrize("n_rows", [1, 100, 4096, 131_072, 1_000_000])
@pytest.mark.parametrize("s", [1, 2, 4, 10, 50, 200])
def test_launch_plan_fills_waves_of_resident_blocks(n_rows, s):
    """K1, K5a and K9's grid: whole tiles a block, every row covered once,
    at most three waves of 3 blocks an SM (one wave at the headline's S =
    10: 39 blocks a restart); ``csrc/em_sweep.cu`` launches ceil(B /
    rows_per_block) blocks, the partials' middle axis."""
    slots = em_bdr.RESIDENT * H100_SMS
    for tile in em_bdr.TILES:
        rpb, blocks = em_bdr.launch_plan(n_rows, s, tile, H100_SMS)
        assert rpb % tile == 0 and blocks == -(-n_rows // rpb)
        assert (blocks - 1) * rpb < n_rows <= blocks * rpb
        assert blocks == 1 or blocks * s <= 3 * slots
        assert em_bdr.launch_plan(n_rows, s, tile, H100_SMS, max_blocks=2)[1] <= 2
    assert em_bdr.launch_plan(131_072, 10, 64, H100_SMS) == (3392, 39)


@pytest.mark.parametrize("k", [1, 4, 9, 10, 13, 16, 20])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_k1_grid_holds_the_blocks_an_sm_holds(k, r):
    """K1's grid is waves of the blocks an SM holds of its instance: its
    launch bound (4 for the K = 10, R = 2 instance, else 3) where shared
    memory allows, fewer where it binds (K = 20, R = 2: one), so no plan
    counts on blocks that would run in an extra wave; at the headline
    (131,072 rows, S = 10, K = 10, R = 2) 4 an SM, 52 blocks a restart of
    2560 rows."""
    plan = em_bdr.sweep_plan(k, r)
    resident = em_bdr.sweep_resident(k, r, plan[1])
    bound = 4 if (k, r) == (10, 2) else 3
    assert 1 <= resident == min(bound, 233_472 // (plan[1] + 1024))
    for n_rows, s in ((131_072, 10), (104_858, 10), (4096, 1), (1_000_000, 50)):
        rpb, blocks = em_bdr.sweep_grid(n_rows, s, k, r, H100_SMS)
        assert (rpb, blocks) == em_bdr.launch_plan(n_rows, s, plan[0], H100_SMS,
                                                   resident=resident)
        assert rpb % plan[0] == 0 and (blocks - 1) * rpb < n_rows <= blocks * rpb
        assert blocks == 1 or blocks * s <= 3 * resident * H100_SMS
    assert em_bdr.sweep_resident(10, 2, em_bdr.sweep_plan(10, 2)[1]) == 4
    assert em_bdr.sweep_resident(10, 3, em_bdr.sweep_plan(10, 3)[1]) == 3
    assert em_bdr.sweep_resident(20, 2, em_bdr.sweep_plan(20, 2)[1]) == 1
    assert em_bdr.sweep_grid(131_072, 10, 10, 2, H100_SMS) == (2560, 52)
    assert em_bdr.sweep_grid(104_858, 10, 10, 2, H100_SMS) == (2048, 52)


@pytest.mark.parametrize("n,s,g,k,private", [
    (131_072, 10, 1000, 10, True),      # the headline: 16 MB of private theta_hats
    (131_072, 1, 10_000, 10, True),     # bd_plan_wide_s50_g10k's S = 1 line
    (131_072, 10, 100_000, 10, False),  # phase 8's K1 beside K4: streams
    (131_072, 1, 12_376, 20, True),     # the S = 1 edge of K1's classic range, K = 20:
                                        # one block an SM, 132 blocks, 131 MB
    (131_072, 1, 12_376, 16, True),     # K = 16 there: two an SM, 256 blocks, 203 MB
    (131_072, 1, 50_000, 10, False),    # K = 10, four an SM: 528 blocks, 1056 MB
    (131_072, 10, 4500, 10, True),
])
def test_k1_theta_form_follows_the_partials_budget(n, s, g, k, private):
    _, blocks = em_bdr.sweep_grid(n, s, k, 2, H100_SMS)
    assert em_bdr.theta_in_part(n, s, g, k, 2, H100_SMS) == private
    assert private == (4 * s * blocks * g * k <= em_bdr.THETA_PART_BYTES)


@pytest.mark.parametrize("s,g,k", [(10, 1000, 10), (1, 200_000, 10), (50, 1000, 28)])
def test_k9_caps_its_blocks_to_the_partials_budget(s, g, k):
    tile = em_rsorted.sweep_plan(k, 512)[0]
    rpb, blocks = em_rsorted.rsorted_launch_plan(131_072, s, g, k, tile, H100_SMS)
    assert blocks == 1 or 4 * s * blocks * g * k <= em_bdr.THETA_PART_BYTES
    assert rpb % tile == 0 and blocks == -(-131_072 // rpb)


@pytest.mark.parametrize("b,r", [(1, 1), (131_072, 2), (1000, 3), (64, 2)])
def test_k3_buffers_mirror_the_kernel(b, r):
    """Pass 1 launches ceil(B / 64) + R blocks a restart (the ll partials'
    width); the streams are [3, B, S K]; p_part holds a K^3 R slot a split;
    the partials a block may leave unwritten start at zero."""
    k, s, splits = 25, 3, 4
    plan = em_large_k.sweep_plan(k, r)
    pk, streams, p_part, ll_part, scale, rowinfo = em_large_k.launch_buffers(
        s, b, k, r, plan, splits, "cpu")
    assert em_large_k.estep_blocks(b, r) == -(-b // em_large_k.ESTEP_ROWS) + r
    assert ll_part.shape == (s, em_large_k.estep_blocks(b, r)) and not ll_part.any()
    assert streams.shape == (3, b, s * k) and scale.shape == (s, b)
    assert p_part.shape == (s, splits, k ** 3 * r) and not p_part.any()
    assert pk.shape == (s, r, k, 2, k, plan.kc) and rowinfo.shape == (b, 4)


def test_bdg_pieces_and_buffers():
    for n, s in ((131_072, 10), (1000, 1), (131_072, 50)):
        rpb, pieces = em_bdg.bdg_pieces(n, s, 64, H100_SMS)
        assert rpb % 64 == 0 and pieces == -(-n // rpb)
        part_th, part_p = em_bdg.bdg_buffers(pieces, s, 10, 2, 64, "cpu")
        assert part_th.shape == (pieces, 2, s, 640)
        assert part_p.shape == (s, pieces, 10 ** 3 * 2 + 1)


def _slots(n, g, seed, hub=None):
    rng = np.random.default_rng(seed)
    trip = rng.integers(0, g, size=(n, 3)).astype(np.int32)
    if hub is not None:
        trip[rng.random(n) < 0.4, hub] = g // 3
    return trip


@pytest.mark.parametrize("g,wb", [(40, 16), (1000, 512), (5000, 512), (1024, 512)])
@pytest.mark.parametrize("positions", [None, (1, 2)])
def test_device_scatter_plan_is_the_host_plan(g, wb, positions):
    trip = _slots(3000, g, g, hub=0)
    cols = list(positions or (0, 1, 2))
    want = em_large_g.make_scatter_plan(trip, g, wb=wb, positions=positions)
    perm, lid, off = em_large_g.device_scatter_plan(
        torch.as_tensor(trip[:, cols]).t().reshape(-1), g, wb)
    np.testing.assert_array_equal(perm.numpy(), want.perm)
    np.testing.assert_array_equal(lid.numpy(), want.lid)
    np.testing.assert_array_equal(off.numpy(), want.offsets)


@pytest.mark.parametrize("g,wb", [(1000, 512), (1024, 512)])
def test_device_scatter_plan_drops_slots_of_no_gene(g, wb):
    """Slots whose id is out of range (K3's rows of an unknown rating get
    -1) sort last, and their block and local id name gene G, which the
    scatter skips; the other slots keep the host plan of the valid ids."""
    genes = torch.as_tensor(_slots(999, g, 1).reshape(-1)).long()
    bad = torch.zeros_like(genes, dtype=torch.bool)
    bad[::7] = True
    genes[bad] = -1
    genes[3] = g + 5
    bad[3] = True
    perm, lid, off = em_large_g.device_scatter_plan(genes, g, wb)
    n_bad = int(bad.sum())
    assert set(perm[-n_bad:].tolist()) == set(torch.nonzero(bad).flatten().tolist())
    q = -(-g // wb)
    blocks = np.searchsorted(off[:q].numpy(), np.arange(len(perm)), side="right") - 1
    gene = blocks * wb + lid.numpy()
    assert (gene[-n_bad:] == g).all() and (gene[:-n_bad] < g).all()
    np.testing.assert_array_equal(gene[:-n_bad], np.sort(genes[~bad].numpy()))


def _k4_position1(vals, lid1, g1_off, wb1, g, piece_rows):
    """``csrc/em_bdg.cu``'s position-1 sum on the host: each piece's share of
    a gene block stored (inside the piece) or left as the piece's head or
    tail, then fixup_kernel's chains of heads in piece order."""
    n, k = vals.shape
    q1 = len(g1_off) - 1
    n_pieces = -(-n // piece_rows)
    out = np.zeros((g, k))
    part = np.full((n_pieces, 2, wb1, k), np.nan)

    def block_of(i):
        return int(np.searchsorted(g1_off[:q1], i, side="right") - 1)

    for j in range(n_pieces):
        r0, r1 = j * piece_rows, min(n, (j + 1) * piece_rows)
        q = block_of(r0)
        while q < q1 and g1_off[q] < r1:
            a, e = max(r0, g1_off[q]), min(r1, g1_off[q + 1])
            if a < e:
                acc = np.zeros((wb1, k))
                for row in range(a, e):
                    acc[lid1[row]] += vals[row]
                head = g1_off[q] < r0
                tail = not head and g1_off[q + 1] > r1
                if head or tail:
                    part[j, int(tail)] = acc
                else:
                    hi = min(g, (q + 1) * wb1) - q * wb1
                    out[q * wb1:q * wb1 + hi] = acc[:hi]
            q += 1
    for j in range(n_pieces):
        r0, r1 = j * piece_rows, min(n, (j + 1) * piece_rows)
        q = block_of(r1 - 1)
        if g1_off[q] < r0 or g1_off[q + 1] <= r1:
            continue
        acc = part[j, 1].copy()
        for m in range(j + 1, n_pieces):
            acc += part[m, 0]
            if g1_off[q + 1] <= min(n, (m + 1) * piece_rows):
                break
        hi = min(g, (q + 1) * wb1) - q * wb1
        out[q * wb1:q * wb1 + hi] = acc[:hi]
    return out


@pytest.mark.parametrize("g,wb1,piece_rows,hub", [
    (1000, 64, 64, None), (1000, 64, 64, 0), (300, 32, 128, 0), (5000, 64, 192, None),
    (200, 512, 64, 0), (333, 32, 8, None),
])
def test_k4_pieces_and_fixup_sum_position_one_once(g, wb1, piece_rows, hub):
    """A gene block inside a piece is stored once; one split over pieces
    (a hub gene's block spans dozens) is summed from its tail and the
    following heads by the piece it began in; every gene gets its rows'
    position-1 marginals exactly once."""
    trip = _slots(4000, g, 7, hub=hub)
    plan = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    rows = trip[plan.order]
    vals = np.random.default_rng(3).random((len(rows), 4))
    got = _k4_position1(vals, plan.lid1, plan.offsets, wb1, g, piece_rows)
    want = np.zeros((g, 4))
    np.add.at(want, rows[:, 0], vals)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    spans = [sum(1 for j in range(-(-len(rows) // piece_rows))
                 if plan.offsets[q] < (j + 1) * piece_rows and plan.offsets[q + 1] > j * piece_rows)
             for q in range(plan.n_blocks)]
    if hub is not None:
        assert max(spans) >= 3  # a block split over three pieces or more


def _keyed_sum(keys, vals):
    """``tip::keyed_sum`` on the host: warp w takes, in entry order, the
    entries whose key hashes to w; per round of 32 of them each key's
    entries are summed in entry order and added to the key's running value
    (a key's rounds follow each other in its one warp)."""
    out = {}
    for warp in range(8):
        mine = [e for e, key in enumerate(keys)
                if key >= 0 and ((key * 2654435761) & 0xFFFFFFFF) >> 29 == warp]
        for r in range(0, len(mine), 32):
            groups = {}
            for e in mine[r:r + 32]:
                groups.setdefault(keys[e], []).append(e)
            for key, es in groups.items():
                v = np.float32(0)
                for e in es:
                    v = np.float32(v + vals[e])
                out[key] = np.float32(out.get(key, np.float32(0)) + v)
    return out


def test_keyed_sum_order_is_a_function_of_the_entries():
    """Each key lies in one warp's list, in entry order, so its sum has one
    order whatever the schedule: a key with at most 32 entries in its warp
    gets the bits of a sequential float32 sum; a hub key (96 of 192
    entries, so its warp takes several rounds) is summed round by round
    and agrees with a float64 sum; a weight-0 row (key -1) takes no part."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5000, size=192)
    keys[::2] = 7
    keys[5] = -1
    vals = rng.random(192).astype(np.float32)
    got = _keyed_sum(keys.tolist(), vals)
    assert -1 not in got and set(got) == set(keys.tolist()) - {-1}
    for key, v in got.items():
        want = np.float32(0)
        for x in vals[keys == key]:
            want = np.float32(want + x)
        if key != 7:
            assert v == want
        assert float(v) == pytest.approx(float(np.sum(vals[keys == key], dtype=np.float64)),
                                         rel=1e-6)


def test_block_sum_plain_version_sums_the_segments():
    rng = np.random.default_rng(0)
    part = torch.as_tensor(rng.random((3, 5, 17)), dtype=torch.float32)
    segs = [block_sum.Segment(part, 0, 10), block_sum.Segment(part, 10, 6),
            block_sum.Segment(part, 16, 1)]
    outs = block_sum.block_sum(segs)
    for g, out in zip(segs, outs):
        assert out.shape == (3, g.width)
        np.testing.assert_allclose(out.numpy(), part[:, :, g.offset:g.offset + g.width].sum(1),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="segments"):
        block_sum.block_sum([])


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 10, 13, 16, 20, 28])
def test_keyed_sum_steps_its_items_without_a_division(k):
    """``tip::keyed_sum`` gives lane l the items i = l, l + 32, ... of a
    round and steps their (group, k) by 32 from (l // K, l % K), with no
    division in the loop; the steps land on (i // K, i % K) for every item
    of the largest round (32 groups)."""
    dg, dk = 32 // k, 32 - (32 // k) * k
    for lane in range(32):
        g, kk = lane // k, lane - (lane // k) * k
        for i in range(lane, 32 * k, 32):
            assert (g, kk) == divmod(i, k)
            g, kk = g + dg, kk + dk
            if kk >= k:
                g, kk = g + 1, kk - k


def _keyed_sum_lanes(keys, vals, old):
    """``tip::keyed_sum`` lane by lane: per warp and round, the groups in
    lane order, item (group, k) on lane i % 32 adds its group's entries in
    entry order and then adds the sum to the destination, one item at a
    time (float32 throughout)."""
    out = {key: old[key].copy() for key in set(keys) if key >= 0}
    k = vals.shape[1]
    for warp in range(8):
        mine = [e for e, key in enumerate(keys)
                if key >= 0 and ((key * 2654435761) & 0xFFFFFFFF) >> 29 == warp]
        for r in range(0, len(mine), 32):
            leaders, members = [], {}
            for e in mine[r:r + 32]:
                if keys[e] not in members:
                    leaders.append(keys[e])
                members.setdefault(keys[e], []).append(e)
            for lane in range(32):
                for i in range(lane, len(leaders) * k, 32):
                    key, kk = leaders[i // k], i % k
                    v = np.float32(0)
                    for e in members[key]:
                        v = np.float32(v + vals[e, kk])
                    out[key][kk] = np.float32(out[key][kk] + v)
    return out


@pytest.mark.parametrize("k,hub", [(10, None), (10, 96), (3, 150), (20, 40)])
def test_keyed_sum_lanes_give_the_round_model_bits(k, hub):
    """The lane-by-lane model of the kernel and the round model of
    :func:`_keyed_sum` (a key's entries summed in entry order per round,
    each round's sum added to the running value) give the same float32
    bits for every (key, k), from a nonzero old value: a hub key whose
    entries span several rounds of its warp is summed ((old + s1) + s2) +
    ... in both."""
    rng = np.random.default_rng(k + (hub or 0))
    keys = rng.integers(0, 1000, size=192)
    if hub:
        keys[rng.permutation(192)[:hub]] = 77
    keys[3] = -1
    vals = rng.random((192, k)).astype(np.float32)
    old = {key: rng.random(k).astype(np.float32) for key in set(keys.tolist())}
    got = _keyed_sum_lanes(keys.tolist(), vals, old)
    assert -1 not in got and set(got) == set(keys.tolist()) - {-1}
    spans = 0
    for kk in range(k):
        from_zero = _keyed_sum(keys.tolist(), vals[:, kk])
        for key, v in got.items():
            sums = _round_sums(keys.tolist(), vals[:, kk], key)
            want = old[key][kk]
            for s in sums:
                want = np.float32(want + s)
            assert v[kk] == want, (key, kk)
            if len(sums) == 1:
                assert v[kk] == np.float32(old[key][kk] + from_zero[key])
            spans += len(sums) > 1
    assert spans > 0 if hub else True


def _round_sums(keys, vals, key):
    """The sums of ``key``'s entries per round of its warp, in order."""
    warp = ((key * 2654435761) & 0xFFFFFFFF) >> 29
    mine = [e for e, x in enumerate(keys)
            if x >= 0 and ((x * 2654435761) & 0xFFFFFFFF) >> 29 == warp]
    sums = []
    for r in range(0, len(mine), 32):
        es = [e for e in mine[r:r + 32] if keys[e] == key]
        if es:
            v = np.float32(0)
            for e in es:
                v = np.float32(v + vals[e])
            sums.append(v)
    return sums
