"""The benchmark's Data S1 cell (``kuzmin2018_qxa_k10.fit_s10_tsv``) on the
CPU: the screen the harness writes (``benchmark/data_s1.py``) read back by
its plain reader and by the port's Kuzmin loader, native and pure-Python;
the loader's spans; K1's key census (``ops/em_bdr.py::key_census``)
against a lane-by-lane walk of ``tip::keyed_sum``; a fit on the screen's
layout against the benchmark's float64 reference; and the route and
sizes the configuration file gives.
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

from benchmark import data_s1, reference, synth  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.config import Config, TrainConfig  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.data import kuzmin  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.native import binding  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bdr  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.train import trainer  # noqa: E402
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger  # noqa: E402

torch.set_num_threads(2)

QUIET = JsonlLogger(None, echo=False)
CONFIG = os.path.join(REPO, "benchmark", "configs", "kuzmin2018_qxa_k10.json")
# tests/test_torch_fit.py's K1 fit tolerances (the reference's
# test_backend_dispatch.py:120-125), p held to theta's.  The float32 plain
# fit against float64 on the screen below (8 pairs x 120 array genes, K = 3,
# S = 3, 30 sweeps) reads at most L 4.0e-6 (relative), theta 3.3e-6, p
# 2.4e-6 over seeds 0, 1, 2, 5 and 2^31 + 3, with MKL_CBWR unset and with
# COMPATIBLE alike (the BLAS path moves a gap by up to 1.6x on an AMD EPYC):
# 25x of room on either path.  The TF32 control reads L 3.3e-3, theta
# 5.9e-4, p 4.7e-4, which every tolerance refuses
# (test_the_tolerances_refuse_the_control).
FIT_RTOL, THETA_ATOL = 1e-4, 1e-4


def _config(**sizes):
    with open(CONFIG) as fh:
        c = json.load(fh)
    c.update(sizes)
    c.update(n_triplets=c["n_query_pairs"] * c["n_array_genes"],
             n_genes=2 * c["n_query_pairs"] + c["n_array_genes"])
    return c


SMALL = dict(n_query_pairs=4, n_array_genes=40)


def test_the_screen_reads_back_the_same_by_each_reader(tmp_path):
    """4 query pairs x 40 array genes: the plain reader gives the planted
    rows and ratings in query order, with the digenic control lines
    dropped, allele suffixes stripped and NaN P-values negative."""
    c = _config(**SMALL)
    path = str(tmp_path / "s1.tsv")
    written = data_s1.write_tsv(path, c, seed=2**31 + 11)
    text = open(path).read()
    assert "\tdigenic\t" in text and "ydl227c" in text and "\tNaN\t" in text
    assert any(s in text for s in data_s1.SUFFIXES)
    assert written.lines == 200 and written.names.shape == (160, 3)
    names, labels = data_s1.read_rows(path, c["p_cutoff"], c["tau_cutoff"])
    np.testing.assert_array_equal(names, written.names)
    np.testing.assert_array_equal(labels, written.ratings)
    # Query order: each pair's two genes on 40 consecutive rows.
    assert (names[:40, :2] == names[0, :2]).all() and (names[40:80, 0] != names[0, 0]).all()


@pytest.mark.parametrize("parser", ["native", "python"])
def test_the_loader_gives_the_plain_readers_rows(tmp_path, monkeypatch, parser):
    c = _config(**SMALL)
    path = str(tmp_path / "s1.tsv")
    data_s1.write_tsv(path, c, seed=7)
    names, labels = data_s1.read_rows(path, c["p_cutoff"], c["tau_cutoff"])
    if parser == "python":
        monkeypatch.setattr(binding, "compiler", lambda: None)
    elif binding.compiler() is None:
        pytest.skip("no g++ on PATH to build the native tokenizer")
    parses = binding.parses
    ds = kuzmin.load_kuzmin_tsv(path)
    assert binding.parses == parses + (parser == "native")
    assert ds.n_genes == c["n_genes"] and ds.gene_names == sorted(ds.gene_names)
    np.testing.assert_array_equal(np.asarray(ds.gene_names)[ds.triplets], names)
    np.testing.assert_array_equal(ds.ratings, labels)


def test_the_loader_records_its_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    path = str(tmp_path / "s1.tsv")
    data_s1.write_tsv(path, _config(**SMALL), seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kuzmin.load_kuzmin_tsv(path)
    names = [e.name for e in prof.events()]
    assert names.count("data.parse") == 1 and names.count("data.pack") == 1


# --- K1's key census ---------------------------------------------------------

def _bucket(key):
    return ((key * 2654435761) & 0xFFFFFFFF) >> 29


def _walk(keys, k):
    """The longest chain of ``tip::keyed_sum`` over one tile's entry keys
    (-1: no entry), walked lane by lane: each warp compacts its keys in
    entry order, then per round of 32 groups them by key (led by the
    lowest lane), numbers the groups by leader lane, and steps lane l
    through items (gi, k) from (l // K, l % K) by (32 // K, 32 % K)."""
    longest = 0
    for warp in range(8):
        mine = [int(x) for x in keys if x >= 0 and _bucket(int(x)) == warp]
        lanes = [0] * 32
        for r in range(0, len(mine), 32):
            kk = mine[r:r + 32]
            leaders = [lane for lane in range(len(kk)) if kk.index(kk[lane]) == lane]
            items = len(leaders) * k
            for lane in range(32):
                gi, kx = lane // k, lane % k
                for i0 in range(0, items, 32):
                    if i0 + lane < items:
                        lanes[lane] += kk.count(kk[leaders[gi]])
                    gi, kx = gi + 32 // k, kx + 32 % k
                    if kx >= k:
                        kx, gi = kx - k, gi + 1
        longest = max(longest, max(lanes))
    return longest


def _tiles(trip, w, s, k, r, n_sm):
    tile = em_bdr.sweep_plan(k, r)[0]
    per_block, blocks = em_bdr.sweep_grid(len(trip), s, k, r, n_sm)
    for b in range(blocks):
        end = min(len(trip), (b + 1) * per_block)
        for row0 in range(b * per_block, end, tile):
            rows = slice(row0, min(row0 + tile, end))
            yield np.where(w[rows, None] != 0, trip[rows], -1).reshape(-1)


def _hub_rows(n_pairs, n_array, shared):
    """Query pairs crossed to an array in query order; each pair's two
    genes in one warp's bucket (``shared``) or in two."""
    genes, pairs = list(range(10 * n_pairs + n_array)), []
    while len(pairs) < n_pairs:
        a = genes.pop(0)
        b = next(x for x in genes if (_bucket(x) == _bucket(a)) == shared)
        genes.remove(b)
        pairs.append((a, b))
    return np.asarray([(a, b, c) for a, b in pairs for c in genes[:n_array]], np.int64)


@pytest.mark.parametrize("layout", ["uniform", "hub_pair", "shared_bucket"])
@pytest.mark.parametrize("k", [10, 3])
def test_key_census_walks_the_key_sum_lane_by_lane(layout, k):
    rng = np.random.default_rng(4)
    if layout == "uniform":
        trip = rng.integers(0, 5000, (700, 3))
    else:
        trip = _hub_rows(5, 140, layout == "shared_bucket")
    w = (rng.random(len(trip)) > 0.05).astype(np.float32)
    s, r, n_sm = 4, 2, 2
    chains = [_walk(t, k) for t in _tiles(trip, w, s, k, r, n_sm)]
    census = em_bdr.key_census(trip, w, s, k, r, n_sm)
    assert census.tiles == len(chains)
    assert census.chain == pytest.approx(np.mean(chains)) and census.chain_max == max(chains)
    keys = [np.unique(t[t >= 0]).size for t in _tiles(trip, w, s, k, r, n_sm)]
    assert census.keys == pytest.approx(np.mean(keys))
    if layout == "uniform":
        assert census.chain_max <= 16
    else:  # a 64-row tile of one pair: its two genes ~61 times each (5% weight 0)
        assert census.chain_max >= 55


# --- a fit on the screen's layout ---------------------------------------------

def _gaps(res, ref):
    got = np.vstack([np.asarray(res.ll_trace, np.float64),
                     np.asarray(res.final_loglik, np.float64)[None]])
    want = torch.cat([ref.ll_trace, ref.final_ll[None]]).numpy()
    return (float(np.max(np.abs(got - want) / np.abs(want))),
            float((res.states.theta.double() - ref.theta).abs().max()),
            float((res.states.p.double() - ref.p).abs().max()))


def _screen_fit(tmp_path, seed, precision="float64"):
    c = _config(n_query_pairs=8, n_array_genes=120, k=3)
    path = str(tmp_path / f"s1_{seed}.tsv")
    data_s1.write_tsv(path, c, seed)
    train, _ = train_test_split(kuzmin.load_kuzmin_tsv(path), 0.2, seed=seed)
    s, sweeps, freq = 3, 30, 10
    gen = synth.torch_generator("cpu", seed, synth.INIT)
    init = ModelState(*synth.ensemble(s, train.n_genes, c["k"], 2, gen, "cpu"))
    cfg = Config(train=TrainConfig(k=c["k"], sweeps=sweeps, samples=s, likelihood_freq=freq))
    res = trainer.fit(cfg, train, device="cpu", logger=QUIET, init_states=init)
    rows = reference.device_rows(train.triplets, train.ratings, train.n_genes, 2, "cpu")
    ref = reference.fit(init.theta, init.p, rows, sweeps, freq, "float64")
    if precision == "tf32":
        res = reference.fit(init.theta, init.p, rows, sweeps, freq, "tf32")
        res = type("Control", (), dict(ll_trace=res.ll_trace.numpy(),
                                       final_loglik=res.final_ll.numpy(),
                                       states=ModelState(res.theta, res.p)))
    return res, ref


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_a_fit_on_the_screen_holds_to_the_float64_reference(tmp_path, seed):
    res, ref = _screen_fit(tmp_path, seed)
    ll, theta, p = _gaps(res, ref)
    assert ll <= FIT_RTOL and theta <= THETA_ATOL and p <= THETA_ATOL, (ll, theta, p)


def test_the_tolerances_refuse_the_control(tmp_path):
    res, ref = _screen_fit(tmp_path, 0, precision="tf32")
    ll, theta, p = _gaps(res, ref)
    assert ll > FIT_RTOL and theta > THETA_ATOL and p > THETA_ATOL, (ll, theta, p)


# --- the cell's configuration ---------------------------------------------------

def test_the_cell_config_takes_k1_with_private_partials():
    with open(CONFIG) as fh:
        c = json.load(fh)
    q, a = c["n_query_pairs"], c["n_array_genes"]
    assert (q, a, c["n_triplets"], c["n_genes"]) == (160, 1250, q * a, 2 * q + a)
    n_train = c["n_triplets"] - int(round(c["n_triplets"] * c["test_fraction"]))
    assert n_train == 160_000 and c["k"] == 10 and c["reduced"] == []
    assert dispatch.route("cuda", 3, c["k"], c["n_ratings"], 10, c["n_genes"], n_train,
                          True) == em_bdr.KERNEL_NAME
    # The H100's 132 SMs: block-private theta_hats of ~33 MB, under the budget.
    assert em_bdr.theta_in_part(n_train, 10, c["n_genes"], c["k"], c["n_ratings"], 132)
    _, blocks = em_bdr.sweep_grid(n_train, 10, c["k"], c["n_ratings"], 132)
    assert 30e6 < 4 * 10 * blocks * c["n_genes"] * c["k"] < 40e6
