"""PyTorch port vs the JAX reference: the bench entry point
(``trigenicinteractionpredictor_tpu_torch/bench.py``, ``bench_quality.py``
and the CLI's ``bench``), on the CPU.

The step the bench times and the quality bench's timed loop run from the
same numpy states as the reference's ``make_sharded_multi_step`` on its
one-device mesh and the reference's ``bench_quality.py`` loop.  The
printed lines carry the reference's keys, and the flags the root scripts'
defaults (read from their source with ``ast``, without importing JAX).
Tolerances: the reference's sharding ones (tests/test_sharding.py) for the
step, atol 1e-5 on theta and p and rtol 1e-5 on L; the scorers' 1e-6
(tests/test_metrics.py) for served scores and each AUC check.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state as jinit
from trigenicinteractionpredictor_tpu.ops import metrics as jmetrics
from trigenicinteractionpredictor_tpu.ops import scoring as jscoring
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch
from trigenicinteractionpredictor_tpu.parallel.mesh import single_device_mesh as jmesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_multi_step,
    replicate,
    shard_batch,
    shard_ensemble,
)
from trigenicinteractionpredictor_tpu_torch import bench, bench_quality
from trigenicinteractionpredictor_tpu_torch.cli import main as cli_main
from trigenicinteractionpredictor_tpu_torch.data import (
    sample_synthetic_dataset,
    train_test_split,
)
from trigenicinteractionpredictor_tpu_torch.models import threefry
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import (
    block_sum,
    dispatch,
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
    score,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-5   # tests/test_sharding.py
SCORE_ATOL = 1e-6         # tests/test_metrics.py
TINY = ["-n", "1024", "-g", "40", "-k", "3", "-s", "2", "--sweeps", "10", "--device", "cpu"]


def _jax_step(ds, states, n_inner, pad_to=0):
    """The reference's chained step on its one-device mesh."""
    if pad_to:
        ds = ds.pad_to(pad_to)
    mesh = jmesh()
    batch = shard_batch(mesh, JBatch(triplets=jnp.asarray(ds.triplets),
                                     ratings=jnp.asarray(ds.ratings),
                                     weights=jnp.asarray(ds.weights)))
    deg = replicate(mesh, jnp.asarray(ds.degrees()))
    step = make_sharded_multi_step(mesh, n_inner)
    th, p = states.numpy()
    return (lambda st: step(st, batch, deg)), shard_ensemble(
        mesh, JState(theta=jnp.asarray(th), p=jnp.asarray(p)))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("route", [dispatch.PLAIN_NAME, em_bdg.KERNEL_NAME])
def test_bench_step_matches_jax_chained_step(route):
    """(a) The step ``measure_engine`` times -- the fit's batch (the bdg
    route: g1 row order and scatter plan, run through the plain versions on
    the CPU) and ``sharded_multi_step`` of 10 sweeps -- chained twice from
    injected states, against ``make_sharded_multi_step(single_device_mesh(), 10)``."""
    n, g, k, s = 2048, 64, 4, 3
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=2, seed=5)
    states = init_state(g, k, 2, samples=s, seed=6)
    step = bench.make_engine_step(ds, dispatch.stats_fn_for(route, k, 2), torch.device("cpu"))
    jstep, jstates = _jax_step(ds, states, bench.CHUNK)
    got, want = states, jstates
    for _ in range(2):
        got, ll = step(got)
        want, jll = jstep(want)
        assert ll.shape == (bench.CHUNK, s)
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=RTOL)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), atol=ATOL)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=ATOL)


def _root_flags(path: str) -> dict:
    """{flag: default} of every ``add_argument`` in a script's source, a
    default that names a module constant resolved to the constant."""
    tree = ast.parse(open(path).read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and isinstance(node.value, ast.Constant)}
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            if default is None:
                value = False if ast.literal_eval(kw["action"]) == "store_true" else None
            elif isinstance(default, ast.Name):
                value = consts[default.id]
            else:
                value = ast.literal_eval(default)
            flags[ast.literal_eval(node.args[-1])] = value
    return flags


@pytest.mark.parametrize("name,port", [("bench.py", bench), ("bench_quality.py", bench_quality)])
def test_flags_and_defaults_are_the_reference_scripts(name, port):
    """(b) The port's scripts take the root scripts' flags with their
    defaults, plus ``--device`` (default ``cuda``)."""
    want = _root_flags(os.path.join(REPO, name))
    got = _root_flags(port.__file__)
    assert got.pop("--device") == "cuda"
    assert got == want
    args = vars(port.parse_args([]))
    for flag, default in want.items():
        assert args[flag.lstrip("-").replace("-", "_")] == default, flag


def test_main_prints_the_reference_line(monkeypatch, capsys):
    """(b) The last line has exactly the reference's keys; ``shape`` only
    when the shape is not the headline one; ``--warm-only`` prints the
    reference's warm_only line."""
    monkeypatch.setattr(bench, "measure_baseline", lambda args: 1000.0)
    assert bench.main(TINY) == 0
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "shape"}
    assert line["metric"] == "em_restart_triplet_updates_per_sec_per_chip"
    assert line["unit"] == "triplets/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1000.0, rel=1e-6, abs=0.1)
    assert line["shape"] == {"n": 1024, "g": 40, "k": 3, "s": 2}
    assert "S=1 route torch" in out.err and "S=2 route torch" in out.err

    headline = bench.EngineRun(bench.S, "torch", 1.0, 120, 2.5e9, 0.0, {})
    monkeypatch.setattr(bench, "measure_engine", lambda args: [headline])
    assert bench.main(["--device", "cpu"]) == 0
    assert _last_json(capsys.readouterr().out) == {
        "metric": "em_restart_triplet_updates_per_sec_per_chip", "value": 2.5e9,
        "unit": "triplets/s", "vs_baseline": 2.5e6}

    monkeypatch.undo()
    assert bench.main(TINY + ["--warm-only"]) == 0
    assert _last_json(capsys.readouterr().out) == {"metric": "warm_only", "value": 1,
                                                   "unit": "cache"}


def test_serve_prints_the_reference_line_and_scores_as_jax(capsys):
    """(c) ``--serve`` prints the reference's serving line; the scorer it
    times gives the JAX ensemble scores."""
    argv = ["--serve", "-n", "600", "-g", "30", "-k", "4", "-s", "3", "--device", "cpu"]
    assert bench.main(argv) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "shape"}
    assert line["metric"] == "ensemble_serving_rows_per_sec_per_chip"
    assert line["unit"] == "rows/s" and line["value"] > 0 and line["vs_baseline"] == 0.0
    assert line["shape"] == {"n": 600, "g": 30, "k": 4, "s": 3}
    run = bench.measure_serving(bench.parse_args(argv))
    assert run.route == "torch" and run.launches == {} and run.scores.shape == (600,)
    th, p = run.states.numpy()
    want = jscoring.ensemble_predict_interaction(
        JState(jnp.asarray(th), jnp.asarray(p)), jnp.asarray(run.triplets.numpy()))
    np.testing.assert_allclose(run.scores.numpy(), np.asarray(want), atol=SCORE_ATOL)


def test_quality_loop_matches_jax_loop():
    """(d) ``bench_quality``'s timed loop and the reference's loop (its
    train split padded to 512 rows with weight-0 rows, as it pads) from one
    injected state: the same ensemble AUC at every check, the same
    sweeps_to_converged, the final L row within rtol 1e-5."""
    n, g, k, s, sweeps, freq, tol = 4096, 40, 3, 10, 60, 10, bench_quality.TOL
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=2, alpha_theta=0.2,
                                        alpha_p=0.2, seed=0)
    train, test = train_test_split(ds, 0.2, seed=0)
    states = init_state(g, k, 2, samples=s, seed=11)
    dev = torch.device("cpu")
    stats_fn = dispatch.resolve_stats_fn(dev, 3, g, k, s, n_rows=train.n_rows)
    step = bench.make_engine_step(train, stats_fn, dev, freq)
    run = bench_quality.train_to_converged(step, states, bench_quality.auc_checker(test),
                                           sweeps, freq, tol)

    jstep, jst = _jax_step(train, states, freq, pad_to=512)
    trips = jnp.asarray(test.triplets)
    labels = jnp.asarray((test.ratings == 1).astype(np.int32))
    w = jnp.asarray(test.weights)
    aucs = []
    for _ in range(sweeps // freq):
        jst, jll = jstep(jst)
        aucs.append(float(jmetrics.auc(jscoring.ensemble_predict_interaction(jst, trips),
                                       labels, w)))
    jconv = next((i + 1) * freq for i, a in enumerate(aucs) if a >= aucs[-1] - tol)

    assert [sw for _, sw, _ in run.history] == list(range(freq, sweeps + 1, freq))
    np.testing.assert_allclose([a for _, _, a in run.history], aucs, atol=1e-6)
    assert run.sweeps_to_converged == jconv
    np.testing.assert_allclose(run.final_ll, np.asarray(jll[-1]), rtol=RTOL)
    assert run.seconds_per_sweep > 0 and run.auc_final == run.history[-1][2]


@pytest.mark.parametrize("seed,s,g,k,r,alpha", [
    (0, 10, 200, 4, 2, 1.0),   # the recoverable record's draw
    (0, 3, 1000, 10, 2, 1.0),  # the default record's G and K
    (3, 4, 50, 6, 3, 0.5),     # alpha < 1: the boosted gamma
    (12345, 2, 30, 21, 2, 2.0),
])
def test_reference_init_draw_matches_jax(seed, s, g, k, r, alpha):
    """``bench_quality``'s restarts are the reference's own draw at the
    seed: ``vmap(init_state)(split(key(seed), S))``.  The integer steps are
    exact; the float32 ones (log-space gamma, erf_inv, softmax) agree to a
    few ulps of values up to ~16 in log space, so rtol 1e-5."""
    keys = jax.random.split(jax.random.key(seed), s)
    assert (threefry.split(threefry.key(seed), s)
            == np.asarray(jax.random.key_data(keys))).all()
    want = jax.vmap(lambda kk: jinit(kk, g, k, r, alpha=alpha))(keys)
    got = threefry.reference_init_states(seed, s, g, k, r, alpha=alpha)
    for a, b in ((got.theta, want.theta), (got.p, want.p)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_quality_main_prints_the_reference_keys(capsys):
    """The quality bench's last line carries the reference's keys."""
    assert bench_quality.main(["-n", "2048", "-g", "30", "-k", "3", "-s", "2",
                               "--max-sweeps", "20", "--device", "cpu"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "auc_final", "auc_bayes",
                         "sweeps_to_converged", "seconds_per_sweep", "shape"}
    assert line["metric"] == "seconds_to_converged_auc" and line["unit"] == "s"
    assert line["sweeps_to_converged"] in (10, 20) and 0.0 <= line["auc_final"] <= 1.0
    assert line["shape"] == {"n": 2048, "g": 30, "k": 3, "s": 2, "alpha": 0.2, "seed": 0}


def test_cli_bench_runs_in_process_and_refuses_a_missing_gpu(monkeypatch, capsys):
    """(e) The CLI's ``bench`` returns 0 and prints the line; without a GPU
    ``--device cuda`` (the default) raises and names ``--device cpu``, in
    both benches."""
    monkeypatch.setattr(bench, "measure_baseline", lambda args: 1000.0)
    assert cli_main(["bench"] + TINY) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["metric"] == "em_restart_triplet_updates_per_sec_per_chip"
    assert line["shape"] == {"n": 1024, "g": 40, "k": 3, "s": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: cli_main(["bench", "-n", "1024"]),
                lambda: bench.main(["--serve", "-n", "1024"]),
                lambda: bench_quality.main(["-n", "1024"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            run()


def test_launch_check_raises_when_a_routed_kernel_did_not_launch(monkeypatch):
    """(f) Every kernel route names its kernels; the check raises when one
    of them did not launch once a call, and the bench raises when its route
    names a kernel whose counter did not move (a silent fall-through)."""
    sums = block_sum.KERNEL_NAME
    kernels = {
        em_bdr.KERNEL_NAME: {em_bdr.KERNEL_NAME, sums},
        em_large_k.KERNEL_NAME: {em_large_k.KERNEL_NAME, em_bd.SCATTER_NAME, sums},
        em_hybrid.KERNEL_NAME: {em_hybrid.KERNEL_NAME, em_bd.SCATTER_NAME, sums},
        em_bdg.KERNEL_NAME: {em_bdg.ESTEP_NAME, em_bd.SCATTER_NAME, sums},
        em_bd.KERNEL_NAME: {em_bd.STREAMS_NAME, em_bd.SCATTER_NAME, sums},
        em_large_g.KERNEL_NAME: {em_bd.STREAMS_NAME, em_bd.SCATTER_NAME, sums},
        score.KERNEL_NAME: {score.KERNEL_NAME},
        dispatch.PLAIN_NAME: set(),
    }
    for route, names in kernels.items():
        assert set(bench.route_counters(route)) == names, route
        bench.check_launches(route, dict.fromkeys(names, 40), 40)
        for name in names:
            with pytest.raises(RuntimeError, match=name):
                bench.check_launches(route, {**dict.fromkeys(names, 40), name: 39}, 40)

    fake = functools.partial(dispatch.plain_stats)
    fake.kernel_name = em_bdr.KERNEL_NAME
    monkeypatch.setattr(bench, "resolve_stats_fn", lambda *a, **kw: fake)
    monkeypatch.setattr(bench, "measure_baseline", lambda args: 1000.0)
    with pytest.raises(RuntimeError, match=f"route {em_bdr.KERNEL_NAME}: kernel "
                                           f"{em_bdr.KERNEL_NAME} launched 0 times"):
        bench.main(TINY)


def test_route_kernels_name_every_route_and_refuse_others():
    """(f) ``ops/dispatch.py`` owns the route-to-kernel map the launch check
    reads: every route ``route`` can return has its wrappers, each with a
    launch count, and a route it does not know raises in the map and in the
    check, so no route passes the check unchecked."""
    for name in (dispatch.PLAIN_NAME, em_bdr.KERNEL_NAME, em_large_k.KERNEL_NAME,
                 em_hybrid.KERNEL_NAME, em_bdg.KERNEL_NAME, em_bd.KERNEL_NAME,
                 em_large_g.KERNEL_NAME):
        fns = dispatch.route_kernels(name)
        assert all(isinstance(fn.launches, int) and fn.kernel_name for fn in fns), name
        assert bool(fns) == (name != dispatch.PLAIN_NAME), name
    with pytest.raises(ValueError, match="unknown sweep route"):
        dispatch.route_kernels("cuda-em-new")
    with pytest.raises(ValueError, match="unknown sweep route"):
        bench.check_launches("cuda-em-new", {}, 10)


def test_cli_bench_takes_the_bench_flags(capsys):
    """(e) The CLI's ``bench`` parses with ``bench.arg_parser``, so it takes
    every flag of ``bench.py`` with its default: ``--serve`` prints the
    serving line, ``--warm-only`` the warm_only line, and a ``--sweeps``
    under one chained step is refused."""
    tiny = ["-n", "600", "-g", "30", "-k", "4", "-s", "2", "--device", "cpu"]
    assert cli_main(["bench", "--serve"] + tiny) == 0
    assert _last_json(capsys.readouterr().out)["metric"] == (
        "ensemble_serving_rows_per_sec_per_chip")
    assert cli_main(["bench", "--warm-only"] + tiny) == 0
    assert _last_json(capsys.readouterr().out) == {"metric": "warm_only", "value": 1,
                                                   "unit": "cache"}
    with pytest.raises(SystemExit, match="--sweeps must be at least 10"):
        cli_main(["bench", "--sweeps", "5"] + tiny)


def test_sweeps_count_only_whole_steps_and_under_one_step_is_refused(monkeypatch):
    """The reference's ``--sweeps`` fault is not copied (root ``bench.py:243,
    247``: its loop runs ``SWEEPS // chunk`` steps but its rate counts
    ``SWEEPS``, so 25 sweeps overstate the rate by 25/20 and fewer than 10
    time no step).  The port times ``n_chunks`` whole steps and counts
    ``n_chunks * CHUNK`` sweeps; ``--sweeps`` below one step is refused."""
    for bad in ("0", "5", "9"):
        argv = [a if a != "10" else bad for a in TINY]
        with pytest.raises(SystemExit, match="at least 10"):
            bench.main(argv)
    args = bench.parse_args([a if a != "10" else "25" for a in TINY])
    ds, _, _ = sample_synthetic_dataset(args.n, args.genes, args.k, n_ratings=bench.R, seed=0)
    steps = []
    real_step = bench.make_engine_step

    def counting(*a, **kw):
        step = real_step(*a, **kw)

        def run(states):
            steps.append(1)
            return step(states)
        return run

    monkeypatch.setattr(bench, "make_engine_step", counting)
    run = bench.engine_run(args, ds, torch.device("cpu"), 2, reps=1)
    assert run.sweeps == 2 * bench.CHUNK and len(steps) == 1 + 2
    assert run.updates_per_sec == pytest.approx(run.sweeps * ds.n_rows * 2 / run.seconds)
