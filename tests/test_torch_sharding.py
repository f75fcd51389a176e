"""PyTorch port vs the JAX reference: the data- and ensemble-parallel EM
sweep (``parallel/sharded_em.py``, ``parallel/mesh.py``) and the sharded
stepwise update (``ops/stepwise.py`` over a mesh), on the CPU.

The port runs as gloo ranks (world 4: data 2 x ensemble 2; world 2: data
2), one spawn a world, each checking several functions and writing an
``.npz``; the reference runs ``make_sharded_train_step`` /
``make_sharded_multi_step`` / ``make_sharded_likelihood`` /
``make_sharded_stepwise_epoch`` on the same mesh shape of its virtual CPU
devices (tests/conftest.py), from the same numpy states.  Tolerances are
the reference's own (tests/test_sharding.py): atol 1e-5 on theta and p,
rtol 1e-5 on L.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import torch_ranks
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch, SweepStats as JStats
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh as jmake_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_likelihood,
    make_sharded_multi_step,
    make_sharded_stepwise_epoch,
    make_sharded_train_step,
    replicate,
    shard_batch,
    shard_ensemble,
)
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import make_mesh, single_device_mesh

ATOL, RTOL = 1e-5, 1e-5
N, G, K, S, N_INNER, N_MB = 512, 24, 3, 4, 3, 2
WORLDS = {"data2_ensemble2": (2, 2), "data2": (2, 1)}

WORKER = torch_ranks.WORKER_PRELUDE + r"""
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import state_from_numpy
from trigenicinteractionpredictor_tpu_torch.ops.em import Batch, SweepStats, make_batch
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import plain_stats
from trigenicinteractionpredictor_tpu_torch.ops.stepwise import stepwise_group
from trigenicinteractionpredictor_tpu_torch.parallel import sharded_em as se
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import (
    DATA_AXIS, ENSEMBLE_AXIS, make_mesh)

inp, out, data, ens = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
z = np.load(inp)
refusals = []
for kw in ({"data": 1}, {"ensemble": 3}, {"data": 2 * WORLD}):
    try:
        make_mesh(**kw)
    except ValueError as e:
        refusals.append(str(e))
mesh = make_mesh(data=data, ensemble=ens)
lo, hi = se.shard_rows(len(z["ratings"]), mesh)
batch = make_batch(z["triplets"][lo:hi], z["ratings"][lo:hi], z["weights"][lo:hi], "cpu")
deg = torch.as_tensor(z["degrees"])
states = se.shard_ensemble(state_from_numpy(z["theta"], z["p"]), mesh)
res = {"rows": np.array([hi - lo])}

st, ll = se.sharded_step(states, batch, deg, mesh)
g = se.gather_states(st, mesh)
res.update(step_theta=g.theta, step_p=g.p, step_ll=se.gather_loglik(ll, mesh))
for name, betas in (("multi", None), ("anneal", z["betas"])):
    st, hist = se.sharded_multi_step(states, batch, deg, mesh, len(z["betas"]), betas=betas)
    g = se.gather_states(st, mesh)
    res.update({name + "_theta": g.theta, name + "_p": g.p,
                name + "_ll": se.gather_blocks(hist, mesh, ENSEMBLE_AXIS, dim=1)})
res["ll"] = se.gather_loglik(se.sharded_likelihood(states, batch, mesh, row_chunk=100), mesh)

# The stepwise update on this rank's slice of each minibatch.
width = z["mb_triplets"].shape[1] // data
cols = slice(mesh.index(DATA_AXIS) * width, (mesh.index(DATA_AXIS) + 1) * width)
mbs = Batch(*(torch.as_tensor(z[key][:, cols]) for key in ("mb_triplets", "mb_ratings",
                                                           "mb_weights")))
ema = SweepStats(*(se.block(torch.as_tensor(z[key]), mesh, ENSEMBLE_AXIS)
                   for key in ("ema_theta_hat", "ema_p_hat", "ema_loglik")))
st, ema, llg, t = stepwise_group(states, ema, torch.tensor(float(z["t0"])), mbs, deg,
                                 torch.tensor(z["w_total"]), plain_stats, kappa=0.6, t0=2.0,
                                 mesh=mesh)
g = se.gather_states(st, mesh)
res.update(sw_theta=g.theta, sw_p=g.p, sw_ll=se.gather_loglik(llg, mesh), sw_t=t,
           **{"sw_ema_" + f: se.gather_blocks(x, mesh, ENSEMBLE_AXIS)
              for f, x in zip(("theta_hat", "p_hat", "loglik"), ema)})
if RANK == 0:
    np.savez(out, refusals=np.array(refusals),
             **{k: v.numpy() if torch.is_tensor(v) else v for k, v in res.items()})
shutdown()
"""


def _inputs():
    ds, _, _ = sample_synthetic_dataset(N, G, K, n_ratings=2, seed=5)
    rng = np.random.default_rng(11)
    w = ds.weights.copy()
    w[::7] = 0.0
    theta = rng.dirichlet(np.ones(K), size=(S, G)).astype(np.float32)
    p = rng.dirichlet(np.ones(2), size=(S, K, K, K)).astype(np.float32)
    return dict(
        triplets=ds.triplets, ratings=ds.ratings, weights=w,
        degrees=ds.degrees(), theta=theta, p=p,
        betas=np.asarray([0.3, 0.6, 1.0], np.float32),
        mb_triplets=ds.triplets.reshape(N_MB, N // N_MB, 3),
        mb_ratings=ds.ratings.reshape(N_MB, N // N_MB),
        mb_weights=w.reshape(N_MB, N // N_MB),
        ema_theta_hat=(rng.random((S, G, K)) * 50).astype(np.float32),
        ema_p_hat=(rng.random((S, K, K, K, 2)) * 50).astype(np.float32),
        ema_loglik=np.zeros(S, np.float32),
        t0=np.float32(3.0), w_total=np.float32(w.sum()),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started together: {world name: (inputs, outputs)}."""
    tmp = tmp_path_factory.mktemp("sharding")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = {name: torch_ranks.start_world(str(script), data * ens,
                                           [tmp / "in.npz", tmp / f"{name}.npz", data, ens])
             for name, (data, ens) in WORLDS.items()}
    for p in procs.values():
        torch_ranks.wait(p)
    return {name: (inp, dict(np.load(tmp / f"{name}.npz"))) for name in WORLDS}


def _jax_inputs(inp, name):
    data, ens = WORLDS[name]
    mesh = jmake_mesh(data=data, ensemble=ens)
    batch = shard_batch(mesh, JBatch(triplets=jnp.asarray(inp["triplets"]),
                                     ratings=jnp.asarray(inp["ratings"]),
                                     weights=jnp.asarray(inp["weights"])))
    states = shard_ensemble(mesh, JState(theta=jnp.asarray(inp["theta"]),
                                         p=jnp.asarray(inp["p"])))
    return mesh, batch, states, replicate(mesh, jnp.asarray(inp["degrees"]))


def _close(got_theta, got_p, want):
    np.testing.assert_allclose(got_theta, np.asarray(want.theta), atol=ATOL)
    np.testing.assert_allclose(got_p, np.asarray(want.p), atol=ATOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_step_matches_jax(runs, name):
    inp, out = runs[name]
    mesh, batch, states, deg = _jax_inputs(inp, name)
    want, want_ll = make_sharded_train_step(mesh)(states, batch, deg)
    _close(out["step_theta"], out["step_p"], want)
    np.testing.assert_allclose(out["step_ll"], np.asarray(want_ll), rtol=RTOL)
    data = WORLDS[name][0]
    assert int(out["rows"][0]) == N // data  # rank 0's contiguous range


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_multi_step_matches_jax(runs, name, annealed):
    """Chained sweeps, plain and annealed on (theta^beta, p^beta) with the
    unpowered carry normalized; the per-sweep L history too."""
    inp, out = runs[name]
    mesh, batch, states, deg = _jax_inputs(inp, name)
    step = make_sharded_multi_step(mesh, N_INNER, annealed=annealed)
    if annealed:
        want, hist = step(states, batch, deg, replicate(mesh, jnp.asarray(inp["betas"])))
    else:
        want, hist = step(states, batch, deg)
    tag = "anneal" if annealed else "multi"
    _close(out[tag + "_theta"], out[tag + "_p"], want)
    np.testing.assert_allclose(out[tag + "_ll"], np.asarray(hist), rtol=RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_likelihood_matches_jax(runs, name):
    inp, out = runs[name]
    mesh, batch, states, _ = _jax_inputs(inp, name)
    want = make_sharded_likelihood(mesh)(states, batch)
    np.testing.assert_allclose(out["ll"], np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_stepwise_epoch_matches_jax(runs, name):
    """ops/stepwise.py over the mesh (each rank a slice of every minibatch,
    stats and W_mb summed over data) equals make_sharded_stepwise_epoch,
    from a non-zero EMA carry and t = 3."""
    inp, out = runs[name]
    mesh, _, states, deg = _jax_inputs(inp, name)
    batches = JBatch(triplets=jnp.asarray(inp["mb_triplets"]),
                     ratings=jnp.asarray(inp["mb_ratings"]),
                     weights=jnp.asarray(inp["mb_weights"]))
    ema = JStats(*(jnp.asarray(inp["ema_" + f]) for f in ("theta_hat", "p_hat", "loglik")))
    step = make_sharded_stepwise_epoch(mesh, N_MB, kappa=0.6, t0=2.0)
    want, want_ema, want_ll, want_t = step(states, ema, jnp.asarray(inp["t0"]), batches, deg,
                                           jnp.asarray(inp["w_total"]))
    _close(out["sw_theta"], out["sw_p"], want)
    assert float(out["sw_t"]) == float(want_t) == float(inp["t0"]) + N_MB
    for f, w in zip(("theta_hat", "p_hat", "loglik"), want_ema):
        np.testing.assert_allclose(out["sw_ema_" + f], np.asarray(w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["sw_ll"], np.asarray(want_ll), rtol=RTOL)


def test_make_mesh_refuses_what_the_world_cannot_hold(runs):
    """The reference's ValueErrors (sizes that do not divide or exceed the
    world), plus a mesh smaller than the world, which one process a rank
    cannot leave ranks out of; in one process the same rules hold over a
    world of one, and the one-rank mesh has no process group."""
    msgs = list(runs["data2_ensemble2"][1]["refusals"])
    assert len(msgs) == 3
    assert "covers 1 of 4 ranks" in msgs[0]
    assert "not divisible by ensemble*model=3" in msgs[1]
    assert "needs 8 devices, have 4" in msgs[2]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(data=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(ensemble=2)
    one = make_mesh()
    assert one.shape == single_device_mesh().shape == {"ensemble": 1, "model": 1, "data": 1}
    assert not one.distributed and one.is_coordinator
