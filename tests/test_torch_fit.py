"""The PyTorch port's slice end to end vs the JAX reference, on the CPU:
fit, checkpoints, evaluate, predict, the CLI, and a jax-free import.

Both packages start from the same numpy initial arrays (their random
draws differ by design).  Fit tolerances are the reference's own for a
kernel-vs-jnp fit (tests/test_backend_dispatch.py:120-125): final L and
the L trace rtol 1e-4, theta atol 1e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import (
    Config,
    EngineConfig,
    MeshConfig,
    TrainConfig,
)
from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.eval import evaluate as jevaluate
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops.scoring import (
    serve_predict_interaction as jserve,
)
from trigenicinteractionpredictor_tpu.train import checkpoint as jckpt
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch.eval import evaluate
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops.scoring import serve_predict_interaction
from trigenicinteractionpredictor_tpu_torch.train import checkpoint as tckpt
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_RTOL = 1e-4     # reference tests/test_backend_dispatch.py:120-122
THETA_ATOL = 1e-4   # reference tests/test_backend_dispatch.py:123-125
QUIET = JsonlLogger(None, echo=False)


def _split(arity=3, k=3, seed=1):
    ds, _, _ = sample_synthetic_dataset(600, 30, k, n_ratings=2, seed=seed, arity=arity)
    return train_test_split(ds, 0.2, seed=0)


def _cfg(tmp, **train):
    base = dict(k=3, sweeps=12, samples=2, likelihood_freq=4)
    base.update(train)
    return Config(
        train=TrainConfig(**base),
        engine=EngineConfig(backend="jnp"),
        out_dir=str(tmp),
    )


def _init(train, k, s, seed=3):
    st = init_state(train.n_genes, k, train.n_ratings, arity=train.arity,
                    samples=s, seed=seed)
    th, p = st.numpy()
    return st, JState(theta=th, p=p)


def _assert_fit_equal(tres, jres):
    assert tres.sweeps_run == jres.sweeps_run
    assert tres.ll_trace.shape == jres.ll_trace.shape
    np.testing.assert_allclose(tres.ll_trace, jres.ll_trace, rtol=FIT_RTOL)
    np.testing.assert_allclose(tres.final_loglik, jres.final_loglik, rtol=FIT_RTOL)
    np.testing.assert_allclose(
        tres.states.theta.numpy(), np.asarray(jres.states.theta), atol=THETA_ATOL
    )


@pytest.mark.parametrize(
    "arity,train_kw",
    [
        (3, {}),
        (2, {}),                                   # digenic family
        (3, {"sweeps": 40, "tol": 1e9}),           # early stop, one check late
    ],
)
def test_fit_matches_jax_fit(tmp_path, arity, train_kw):
    train, _ = _split(arity=arity)
    cfg = _cfg(tmp_path, **train_kw)
    tinit, jinit = _init(train, 3, 2)
    jres = jfit(cfg, train, logger=QUIET, init_states=jinit)
    tres = fit(cfg, train, device="cpu", logger=QUIET, init_states=tinit)
    _assert_fit_equal(tres, jres)
    assert tres.dispatch["kernel"] == "torch" and tres.dispatch["device"] == "cpu"
    if "tol" in train_kw:
        assert tres.sweeps_run == 12 < cfg.train.sweeps


def test_checkpoints_cross_read_and_resume(tmp_path):
    """A checkpoint the port writes resumes in the JAX package and in the
    port, and both land where an uninterrupted port fit lands; the JAX
    package's checkpoint loads in the port and evaluates to the same
    EvalReport."""
    train, test = _split()
    tinit, jinit = _init(train, 3, 2)
    straight = fit(_cfg(tmp_path), train, device="cpu", logger=QUIET, init_states=tinit)

    half = str(tmp_path / "half.npz")
    fit(_cfg(tmp_path, sweeps=6, checkpoint_every=6), train, device="cpu",
        logger=QUIET, init_states=tinit, checkpoint_path=half)
    ck = jckpt.load_checkpoint(half)                       # port -> JAX
    assert ck["sweep"] == 6 and ck["states"].theta.shape == (2, 30, 3)
    assert json.loads(bytes(ck["extra"]["dispatch_json"]).decode())["kernel"] == "torch"
    t_resumed = fit(_cfg(tmp_path), train, device="cpu", logger=QUIET, resume=half)
    j_resumed = jfit(_cfg(tmp_path), train, logger=QUIET, resume=half)
    _assert_fit_equal(t_resumed, j_resumed)
    # the 6-sweep run also checked L at its last sweep: rows 4, 6, 8, 12
    np.testing.assert_allclose(t_resumed.ll_trace[[0, 2, 3]], straight.ll_trace, rtol=1e-6)
    np.testing.assert_allclose(
        t_resumed.states.theta.numpy(), straight.states.theta.numpy(), atol=1e-6
    )

    jpath = str(tmp_path / "jax.npz")                      # JAX -> port
    jres = jfit(_cfg(tmp_path), train, logger=QUIET, init_states=jinit,
                checkpoint_path=jpath)
    loaded = tckpt.load_checkpoint(jpath)
    assert loaded["sweep"] == 12
    np.testing.assert_array_equal(loaded["states"].theta.numpy(),
                                  np.asarray(jres.states.theta))
    rep = evaluate(loaded["states"], test, jres.final_loglik).to_dict()
    want = jevaluate(jres.states, test, jres.final_loglik).to_dict()
    assert rep.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(rep[key], val, rtol=1e-5, err_msg=key)


def test_predict_matches_jax_serve(tmp_path):
    """Scores from a port checkpoint equal the JAX package's serving path
    (fast=False) on the same parameters."""
    train, test = _split()
    tinit, _ = _init(train, 3, 3)
    path = str(tmp_path / "m.npz")
    fit(_cfg(tmp_path, samples=3), train, device="cpu", logger=QUIET,
        init_states=tinit, checkpoint_path=path)
    states = tckpt.load_checkpoint(path)["states"]
    ck = jckpt.load_checkpoint(path)
    want = jserve(JState(jnp.asarray(ck["states"].theta), jnp.asarray(ck["states"].p)),
                  test.triplets, fast=False)
    got = serve_predict_interaction(states, test.triplets)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_e2e_recovers_near_bayes_auc():
    """The reference's e2e synthetic config (tests/test_e2e_synthetic.py),
    through the port on the CPU: the held-out ensemble AUC lands within
    0.03 of the generating model's own AUC, the reference's bound."""
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import state_from_numpy
    from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc
    from trigenicinteractionpredictor_tpu_torch.ops.scoring import predict_interaction

    ds, theta_star, p_star = sample_synthetic_dataset(
        4000, n_genes=50, k=4, n_ratings=2, alpha_theta=0.2, alpha_p=0.2, seed=7
    )
    train, test = train_test_split(ds, 0.2, seed=0)
    cfg = Config(train=TrainConfig(k=4, sweeps=500, samples=8, likelihood_freq=50))
    res = fit(cfg, train, device="cpu", logger=QUIET)
    trips = torch.as_tensor(test.triplets)
    bayes = float(auc(predict_interaction(state_from_numpy(theta_star, p_star), trips),
                      torch.as_tensor(test.ratings)))
    report = evaluate(res.states, test, res.final_loglik)
    assert report.auc > bayes - 0.03, (report.auc, bayes)
    assert np.all(np.diff(res.ll_trace, axis=0) >= -1e-5 * np.abs(res.ll_trace[:-1]))


@pytest.mark.parametrize(
    "override,error",
    [
        # the reference's stepwise loop skips these without a word; the port refuses
        ({"train": {"minibatch": 64, "anneal_beta0": 0.5}}, NotImplementedError),
        ({"train": {"minibatch": 64, "refine_rounds": 1}}, NotImplementedError),
        ({"train": {"minibatch": 64, "smem_rounds": 1}}, NotImplementedError),
        # the reference's make_mesh: a mesh of 2 ranks on a world of 1
        ({"mesh": {"data": 2}}, ValueError),
        # two dense G x G float64 matrices past 8 GiB
        ({"train": {"init_method": "spectral"}, "genes": 23_171}, ValueError),
    ],
)
def test_unsupported_knob_combinations_are_refused(tmp_path, override, error):
    train, _ = _split()
    if "genes" in override:
        train = dataclasses.replace(train, n_genes=override["genes"])
    cfg = _cfg(tmp_path, **override.get("train", {}))
    if "mesh" in override:
        cfg = cfg.replace(mesh=MeshConfig(**override["mesh"]))
    with pytest.raises(error):
        fit(cfg, train, device="cpu", logger=QUIET)


def test_out_of_range_ids_are_refused(tmp_path):
    train, _ = _split()
    bad = train.select(np.arange(train.n_rows))
    bad.triplets[3, 1] = train.n_genes
    with pytest.raises(ValueError, match="gene ids"):
        fit(_cfg(tmp_path), bad, device="cpu", logger=QUIET)


def test_cli_fit_then_predict(tmp_path):
    """``fit`` then ``predict`` through the port's CLI on the bundled
    example TSV, on the CPU."""
    from trigenicinteractionpredictor_tpu_torch.cli import main

    tsv = os.path.join(REPO, "datasets", "example_trigenic.tsv")
    out = str(tmp_path / "run")
    assert main(["fit", "-f", tsv, "-k", "3", "-i", "20", "-s", "2", "-n", "5",
                 "-o", out, "--device", "cpu", "--checkpoint-every", "10"]) == 0
    report = json.load(open(os.path.join(out, "report.json")))
    assert report["sweeps"] == 20 and 0.0 <= report["auc"] <= 1.0
    for name in ("config.json", "events.jsonl", "model.ckpt.npz",
                 os.path.join("params", "theta_s1.txt"),
                 os.path.join("params", "likelihood.txt")):
        assert os.path.exists(os.path.join(out, name)), name
    events = [json.loads(line)["event"] for line in open(os.path.join(out, "events.jsonl"))]
    assert "dispatch" in events and events[-1] == "fit_done"

    preds = str(tmp_path / "preds.tsv")
    assert main(["predict", "-f", tsv, "--checkpoint", os.path.join(out, "model.ckpt.npz"),
                 "-o", preds, "--device", "cpu"]) == 0
    rows = open(preds).read().splitlines()
    assert rows[0].split("\t") == ["gene_a", "gene_b", "gene_c", "p_interaction"]
    scores = np.array([float(r.split("\t")[-1]) for r in rows[1:]])
    ck = jckpt.load_checkpoint(os.path.join(out, "model.ckpt.npz"))
    ds = load_kuzmin_tsv(tsv)
    want = jserve(JState(jnp.asarray(ck["states"].theta), jnp.asarray(ck["states"].p)),
                  ds.triplets, fast=False)
    np.testing.assert_allclose(scores, want, atol=1e-6)  # written with 6 decimals


def test_cuda_request_without_gpu_names_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")


@pytest.mark.parametrize("override", [{}, {"train": {"minibatch": 4096, "k": 25},
                                          "data": {"tau_mode": "negative"},
                                          "engine": {"backend": "jnp"}, "out_dir": "runs/x"}])
def test_config_copy_serializes_as_the_reference(override):
    """The port's own config module gives the reference's JSON text, and
    either reads the other's."""
    from trigenicinteractionpredictor_tpu_torch.config import Config as TConfig

    d = Config().to_dict()
    for key, val in override.items():
        d[key] = dict(d[key], **val) if isinstance(val, dict) else val
    ref, port = Config.from_dict(d), TConfig.from_dict(d)
    assert port.to_json() == ref.to_json()
    assert TConfig.from_json(ref.to_json()).to_json() == ref.to_json()
    assert Config.from_json(port.to_json()).to_json() == port.to_json()


def test_data_copies_give_the_reference_arrays(tmp_path):
    """The port's data modules (pure-Python Kuzmin parser, packing, splits,
    synthetic generator) give the reference's arrays."""
    from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv as jload
    from trigenicinteractionpredictor_tpu.data.splits import kfold_splits as jfolds
    from trigenicinteractionpredictor_tpu.data.synthetic import write_kuzmin_like_tsv
    from trigenicinteractionpredictor_tpu_torch import data as tdata
    from trigenicinteractionpredictor_tpu_torch.config import DataConfig as TDataConfig

    def same(a, b):
        assert (a.n_genes, a.n_ratings, a.gene_names) == (b.n_genes, b.n_ratings, b.gene_names)
        for name in ("triplets", "ratings", "weights"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))

    tsv = str(tmp_path / "k.tsv")
    write_kuzmin_like_tsv(tsv, n_rows=300, n_genes=25, seed=4)
    for mutant in ("trigenic", "digenic"):
        from trigenicinteractionpredictor_tpu.config import DataConfig

        same(tdata.load_kuzmin_tsv(tsv, TDataConfig(mutant_type=mutant, tau_mode="negative")),
             jload(tsv, DataConfig(mutant_type=mutant, tau_mode="negative")))
    ds, th, p = tdata.sample_synthetic_dataset(500, 20, 3, seed=9)
    jds, jth, jp = sample_synthetic_dataset(500, 20, 3, seed=9)
    same(ds, jds)
    np.testing.assert_array_equal(th, jth)
    for (f, a, b), (_, ja, jb) in zip(tdata.kfold_splits(ds, 3, seed=2), jfolds(jds, 3, seed=2)):
        same(a, ja)
        same(b, jb)
    ds.save_dir(str(tmp_path / "store"))
    same(tdata.TripletDataset.load_dir(str(tmp_path / "store")), jds)


def test_port_imports_no_jax():
    """Importing every module of the port leaves neither jax nor any module
    of the JAX package in sys.modules, and no source file of the port (nor
    chip_smoke.py) imports the JAX package: the port keeps its own copies
    of the config, data and logging modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import trigenicinteractionpredictor_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 51, names\n"
        "for n in ('analysis', 'config', 'data.kuzmin', 'utils.logging', 'ops.em_hybrid',\n"
        "          'ops.stepwise', 'train.stream_prep', 'train.driver', 'ops.em_rsorted',\n"
        "          'ops.rsort_plan', 'utils.integrity', 'models.proposals',\n"
        "          'models.informed_init', 'native.binding', 'parity', 'parallel.mesh',\n"
        "          'parallel.distributed', 'parallel.sharded_em',\n"
        "          'parallel.tensor_parallel', 'bench', 'bench_quality',\n"
        "          'models.threefry'):\n"
        "    assert pkg.__name__ + '.' + n in names, n\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'trigenicinteractionpredictor_tpu')\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]

    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax\b|trigenicinteractionpredictor_tpu\b(?!_))",
                         re.MULTILINE)
    pkg = os.path.join(REPO, "trigenicinteractionpredictor_tpu_torch")
    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _, files in os.walk(pkg) for f in files
        if f.endswith(".py")
    ]
    assert len(sources) >= 52
    offenders = [p for p in sources if pattern.search(open(p).read())]
    assert not offenders, offenders


def _tile_bytes(k, r, tile):
    """``csrc/em_tile.cuh`` carve, written out: p[s] and its cross-stats as
    [R][K][K4][K4], T/U [K^2][NS], theta [3][K4][NS], A [3][K][NS], weights
    and scales [NS], weights by row [tile]; ints: gene ids [3][tile],
    ratings, slots [tile] each, and 8 of segments and counts; T/U takes at
    least 27 tile + 256 words: the keys of the tile's 3 tile entries (row,
    position) and the keyed sum's lists (8 warps x 3 tile entries, 8 x 32
    group lanes), which it holds after the E-step."""
    k4 = 4 * -(-k // 4)
    ns = 4 * -(-tile // 4) + 4 * (r - 1)
    tv = max(k * k * ns, 27 * tile + 256)
    floats = 2 * r * k * k4 * k4 + tv + 3 * k4 * ns + 3 * k * ns + 2 * ns + tile
    return 4 * (floats + 5 * tile + 8)


@pytest.mark.parametrize("k", [1, 2, 7, 10, 13, 17, 19, 20])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_tile_plans_mirror_the_smem_layout(k, r):
    """K1's, K4's and K9's host plans keep their K and R ranges and size
    the new tile buffers byte for byte: K1 takes K = 1..20 at R <= 3 with
    the largest tile that fits, K4 adds two [wb1, K] blocks, K9 carves one
    rating and reaches K = 28."""
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdg, em_bdr, em_rsorted

    limit = 232_448 - 1024
    for tile in em_bdr.TILES:
        assert em_bdr.tile_smem_bytes(k, r, tile) == _tile_bytes(k, r, tile)
    tile, smem = em_bdr.sweep_plan(k, r)
    assert smem == _tile_bytes(k, r, tile) <= limit
    assert all(_tile_bytes(k, r, t) > limit for t in em_bdr.TILES if t > tile)
    tile4, wb1 = em_bdg.bdg_plan(k, r)
    assert em_bdg._smem_bytes(k, r, tile4, wb1) == _tile_bytes(k, r, tile4) + 8 * wb1 * k
    assert em_bdg._smem_bytes(k, r, tile4, wb1) <= limit
    assert em_bdg._tile(k, r, wb1) == tile4
    tile9, smem9 = em_rsorted.sweep_plan(k, 512)
    assert smem9 == _tile_bytes(k, 1, tile9) <= limit


def test_tile_plan_ranges():
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_rsorted

    assert em_bdr.sweep_plan(21, 1) is None and em_bdr.sweep_plan(0, 2) is None
    assert em_bdr.sweep_plan(20, 3) == (8, _tile_bytes(20, 3, 8))
    assert em_bdr.sweep_plan(10, 2) == (64, _tile_bytes(10, 2, 64))
    assert em_rsorted.sweep_plan(28, 512) == (8, _tile_bytes(28, 1, 8))
    assert em_rsorted.sweep_plan(29, 512) is None


def _tile_slots(rr, n_ratings):
    """The slots ``tip::sort_rows`` gives a tile's rows: rating r's rows, in
    row order, from seg[r], each rating's run starting at a multiple of 4."""
    rr = np.asarray(rr)
    cnt = np.bincount(rr, minlength=n_ratings)
    seg = np.concatenate([[0], np.cumsum(-(-cnt // 4) * 4)])
    slots = np.empty(len(rr), np.int64)
    for row, r in enumerate(rr):
        slots[row] = seg[r] + np.count_nonzero(rr[:row] == r)
    return slots, seg


@pytest.mark.parametrize("tile", [8, 16, 32, 64])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_in_block_rating_order_fits_its_slots(tile, r):
    """Every tile of up to ``tile`` rows gets distinct slots in rating order
    (stable), every quad of slots holds one rating, and the slots stay
    within NS = tile rounded up to 4 plus 4 (R - 1) -- the carve's bound --
    for random tiles and for the worst case (one row of each rating but
    the last)."""
    rng = np.random.default_rng(tile * 10 + r)
    ns = 4 * -(-tile // 4) + 4 * (r - 1)
    cases = [rng.integers(0, r, size=rng.integers(1, tile + 1)) for _ in range(50)]
    cases.append(np.array(list(range(r - 1)) + [r - 1] * (tile - r + 1)))
    for rr in cases:
        slots, seg = _tile_slots(rr, r)
        assert len(set(slots.tolist())) == len(rr) and seg[-1] <= ns
        for q in range(r):
            mine = slots[rr == q]
            assert (np.diff(mine) == 1).all() and (len(mine) == 0 or mine[0] == seg[q])
            assert seg[q] % 4 == 0
        quads = {}
        for s_, q in zip(slots, rr):
            assert quads.setdefault(s_ // 4, q) == q
