"""The benchmark's large-G cell (``large_g100k.fit_s10``) on the CPU: the
route its configuration takes, a whole fit on that route against the
benchmark's plain float64 reference (``benchmark/reference.py``, which
imports nothing of the port), and the plans the fit builds on the
batch's device against the host functions that build them.

On the CPU the ``cuda-em-bdg`` stats function runs its kernels' plain
versions (``bdg_estep_reference``, ``plan_scatter_reference``) along the
route's own plans, so the fit below walks the route's whole path but
for the kernels themselves.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import reference, synth  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.config import Config, TrainConfig  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import (  # noqa: E402
    ModelState,
    state_from_numpy,
)
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bd, em_bdg, em_large_g  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.train import trainer  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger  # noqa: E402

torch.set_num_threads(2)

QUIET = JsonlLogger(None, echo=False)
CONFIG = os.path.join(REPO, "benchmark", "configs", "large_g100k.json")
N, G, K, S, R, SWEEPS, FREQ = 2048, 6000, 4, 2, 2, 20, 5
# The float32 fit against float64 over seeds 0-5 at this size: largest gaps
# L 4.5e-6 (relative), theta 1.8e-5, p 2.1e-5.  Each tolerance is 5-11x
# above; the TF32 control reads L >= 2.3e-3 and theta >= 8.3e-3 there,
# which the first two refuse (test_the_tolerances_refuse_the_control).
LL_RTOL, THETA_ATOL, P_ATOL = 5e-5, 2e-4, 1e-4


def _train_rows(n, g, k, seed):
    return synth.train_rows(synth.planted_rows(n, g, k, R, 0.5, 0.5, seed), 0.2, seed)


def test_the_cell_config_takes_the_bdg_route_by_the_pad_rule():
    with open(CONFIG) as fh:
        c = json.load(fh)
    n_train = c["n_triplets"] - int(round(c["n_triplets"] * c["test_fraction"]))
    assert n_train == 104_858
    args = ("cuda", 3, c["k"], c["n_ratings"], 10, c["n_genes"])
    assert dispatch.route(*args, n_train, True) == em_bdg.KERNEL_NAME
    # The pad rule's margin: ceil(G / 512) * 128 = 25,088 rows of pad
    # estimate, admitted while at most a quarter of the rows.
    pad = -(-c["n_genes"] // 512) * 128
    assert pad == 25_088 and pad <= 0.25 * n_train < 1.05 * pad
    assert dispatch.route(*args, 4 * pad, True) == em_bdg.KERNEL_NAME
    assert dispatch.route(*args, 4 * pad - 1, True) == em_bd.KERNEL_NAME


def _gaps(theta, p, trace, final, ref):
    """(relative L gap over the L trace and final L, theta gap, p gap)."""
    got = np.vstack([np.asarray(trace, np.float64), np.asarray(final, np.float64)[None]])
    want = torch.cat([ref.ll_trace, ref.final_ll[None]]).numpy()
    return (float(np.max(np.abs(got - want) / np.abs(want))),
            float((theta.double() - ref.theta).abs().max()),
            float((p.double() - ref.p).abs().max()))


def _case(seed):
    rows = _train_rows(N, G, K, seed)
    n = rows.triplets.shape[0]
    ds = TripletDataset(rows.triplets, rows.ratings, np.ones(n, np.float32), G, R)
    gen = synth.torch_generator("cpu", seed, synth.INIT, 1)
    theta0, p0 = synth.ensemble(S, G, K, R, gen, "cpu")
    ref = reference.fit(theta0, p0, reference.device_rows(rows.triplets, rows.ratings, G, R,
                                                          "cpu"), SWEEPS, FREQ, "float64")
    return ds, theta0, p0, ref


@pytest.mark.parametrize("seed", [0, 2])
def test_a_bdg_fit_holds_to_the_float64_reference(seed):
    ds, theta0, p0, ref = _case(seed)
    assert int((np.bincount(ds.triplets.reshape(-1), minlength=G) == 0).sum()) > G // 4
    cfg = Config(train=TrainConfig(k=K, sweeps=SWEEPS, samples=S, likelihood_freq=FREQ))
    res = trainer.fit(cfg, ds, device="cpu", logger=QUIET,
                      stats_fn=dispatch.stats_fn_for(em_bdg.KERNEL_NAME, K, R),
                      init_states=ModelState(theta0.clone(), p0.clone()))
    assert res.dispatch["kernel"] == em_bdg.KERNEL_NAME
    assert res.ll_trace.shape == (SWEEPS // FREQ, S)
    ll, theta, p = _gaps(res.states.theta, res.states.p, res.ll_trace, res.final_loglik, ref)
    assert ll <= LL_RTOL and theta <= THETA_ATOL and p <= P_ATOL, (ll, theta, p)
    # Genes in no training row keep their initial rows, as in the reference.
    unseen = torch.as_tensor(np.bincount(ds.triplets.reshape(-1), minlength=G) == 0)
    assert torch.equal(res.states.theta[:, unseen], theta0[:, unseen])


def test_the_tolerances_refuse_the_control():
    ds, theta0, p0, ref = _case(0)
    ctl = reference.fit(theta0, p0, reference.device_rows(ds.triplets, ds.ratings, G, R, "cpu"),
                        SWEEPS, FREQ, "tf32")
    ll, theta, _ = _gaps(ctl.theta, ctl.p, ctl.ll_trace.numpy(), ctl.final_ll.numpy(), ref)
    assert ll > LL_RTOL and theta > THETA_ATOL, (ll, theta)


def _host_batch(route, trip, rat, w, g, info):
    """The batch the host plan functions give at the block widths of the
    fit's ``backend`` event ``info``: the plans the route's device plans
    must equal."""
    if route == em_bdg.KERNEL_NAME:
        g1 = em_bdg.make_g1_plan(trip, g, wb1=info["wb1"])
        trip, rat, w = em_bdg.apply_g1_order(g1, trip, rat, w)
        plan = em_large_g.make_scatter_plan(trip, g, wb=info["wb"], positions=(1, 2))
        return make_batch(trip, rat, w, "cpu", scatter=plan, g1=g1)
    plan = em_large_g.make_scatter_plan(trip, g, wb=info["wb"])
    return make_batch(trip, rat, w, "cpu", scatter=plan)


@pytest.mark.parametrize("route", [em_bdg.KERNEL_NAME, em_bd.KERNEL_NAME,
                                   em_large_g.KERNEL_NAME])
@pytest.mark.parametrize("n,g,hub", [(20_000, 100_000, False), (2048, 6000, False),
                                     (500, 300, True)])
def test_the_fit_batch_plans_are_the_host_plans(route, n, g, hub):
    rng = np.random.default_rng(n)
    trip = rng.integers(0, g, size=(n, 3)).astype(np.int32)
    if hub:  # one gene in 40% of the rows at position 1: a long run of one block
        trip[rng.random(n) < 0.4, 0] = g // 2
    rat = rng.integers(0, R, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    fn = dispatch.stats_fn_for(route, 10, R)
    got, info = fn.batch(TripletDataset(trip, rat, w, g, R), torch.device("cpu"))
    assert info["wb"] == em_bd.DEFAULT_WB
    want = _host_batch(route, trip, rat, w, g, info)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b), name


def test_states_from_tensors_are_fresh_float32_copies_with_the_same_bits():
    theta = torch.rand(3, 50, 4, dtype=torch.float64)
    p = torch.rand(3, 4, 4, 4, 2)
    st = state_from_numpy(theta[:, ::2], p, "cpu")
    assert st.theta.dtype == st.p.dtype == torch.float32
    assert st.theta.is_contiguous() and st.p.data_ptr() != p.data_ptr()
    assert torch.equal(st.theta, torch.as_tensor(theta[:, ::2].numpy().astype(np.float32)))
    assert torch.equal(st.p, p)
    p.zero_()
    assert st.p.abs().sum() > 0


def _tiles_by_brute_force(offsets, n_rows, piece_rows, tile):
    """K4's tiles a restart, each the longest run of rows from its first
    that stays in its piece, holds at most ``tile`` rows and rows of at
    most two gene blocks: (tiles, those of two blocks, those cut short by
    the second block's end)."""
    block = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    tiles = crossing = cut = 0
    for r0 in range(0, n_rows, piece_rows):
        r1 = min(n_rows, r0 + piece_rows)
        row0 = r0
        while row0 < r1:
            room = min(tile, r1 - row0)
            n = room
            while len(set(block[row0:row0 + n].tolist())) > 2:
                n -= 1
            tiles += 1
            crossing += len(set(block[row0:row0 + n].tolist())) == 2
            cut += n < room
            row0 += n
    return tiles, crossing, cut


@pytest.mark.parametrize("n,g,wb1,piece_rows,tile,hub", [
    (3000, 100_000, 64, 1024, 64, False),  # ~2 rows a gene block
    (5000, 6000, 64, 320, 64, False),      # ~53 rows a gene block
    (5000, 6000, 32, 192, 32, True),       # a hub gene block over many pieces
    (4001, 300, 256, 128, 16, False),      # two gene blocks of ~2,700 rows
    (700, 40_000, 512, 64, 8, False),      # many empty gene blocks
])
def test_the_tile_census_counts_the_kernels_tiles(n, g, wb1, piece_rows, tile, hub):
    rng = np.random.default_rng(n + g)
    trip = rng.integers(0, g, size=(n, 3)).astype(np.int32)
    if hub:
        trip[rng.random(n) < 0.4, 0] = g // 2
    plan = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    got = em_bdg.bdg_tile_census(plan.offsets, n, piece_rows, tile)
    assert tuple(got) == _tiles_by_brute_force(plan.offsets, n, piece_rows, tile)


@pytest.mark.parametrize("seed", [123, 2**31 + 7])
def test_the_cells_tiles_run_on_past_gene_block_ends(seed):
    """At the cell's rows (104,858, G = 100,000: ~67 rows a gene block of
    64 genes) on an H100's 132 SMs, a restart runs ~1,670 tiles, where
    tiles cut at every gene block's end would number ~2,570."""
    with open(CONFIG) as fh:
        c = json.load(fh)
    rows = synth.train_rows(synth.planted_rows(c["n_triplets"], c["n_genes"], c["k"],
                                               c["n_ratings"], 0.5, 0.5, seed),
                            c["test_fraction"], seed)
    n = rows.triplets.shape[0]
    tile, wb1 = em_bdg.bdg_plan(c["k"], c["n_ratings"])
    plan = em_bdg.make_g1_plan(rows.triplets, c["n_genes"], wb1=wb1)
    piece_rows, pieces = em_bdg.bdg_pieces(n, 10, tile, 132)
    assert (tile, wb1, piece_rows, pieces) == (64, 64, 1024, 103)
    got = em_bdg.bdg_tile_census(plan.offsets, n, piece_rows, tile)
    runs = [max(0, min(e, r0 + piece_rows) - max(a, r0)) for r0 in range(0, n, piece_rows)
            for a, e in zip(plan.offsets[:-1], plan.offsets[1:])]
    cut_at_each_end = sum(-(-r // tile) for r in runs)
    assert 1_650 <= got.tiles <= 1_700 and 2_540 <= cut_at_each_end <= 2_610
    assert got.crossing > 1_400 and got.cut < 60


def test_the_tile_ordered_cross_sums_in_its_order():
    """``tile_ordered_cross`` gives the bits of a float32 sum in its order
    (each tile's rows in row order, then the tiles), and the matmul's value
    in float64."""
    rng = np.random.default_rng(5)
    v, x = rng.random((2, 150, 6)), rng.random((2, 150, 4))
    got = em_bdg.tile_ordered_cross(torch.as_tensor(v, dtype=torch.float32),
                                    torch.as_tensor(x, dtype=torch.float32), max_elems=100)
    prod = v.astype(np.float32)[..., :, None] * x.astype(np.float32)[..., None, :]
    want = np.zeros((2, 6, 4), np.float32)
    for t0 in range(0, 150, 64):
        part = prod[:, t0].copy()
        for i in range(t0 + 1, min(150, t0 + 64)):
            part += prod[:, i]
        want += part
    assert np.array_equal(got.numpy(), want)
    exact = em_bdg.tile_ordered_cross(torch.as_tensor(v), torch.as_tensor(x))
    np.testing.assert_allclose(exact.numpy(), np.swapaxes(v, 1, 2) @ x, rtol=1e-13)
