"""PyTorch port vs the JAX reference: the tensor-parallel sweep over p's l
axis (``parallel/tensor_parallel.py``) and ``fit`` with ``mesh.model > 1``,
on the CPU.

The port runs as gloo ranks at (model, data) = (2, 1) and (2, 2), one
spawn a world: ``tp_step``, the annealed ``tp_multi_step`` and
``tp_likelihood`` against the reference's ``make_tp_train_step`` /
``make_tp_multi_step`` / ``make_tp_likelihood`` on the same mesh shape of
its virtual CPU devices, from the same numpy states (atol 1e-5 on theta
and p, rtol 1e-5 on L: tests/test_tensor_parallel.py:28-33), and a TP
``fit`` at K = 8 against the port's replicated one-process fit of the same
seed (rtol 1e-5 on L, atol 2e-5 on theta and p:
tests/test_tensor_parallel.py:63-72).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import torch_ranks
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch
from trigenicinteractionpredictor_tpu.parallel.tensor_parallel import (
    make_tp_likelihood,
    make_tp_mesh,
    make_tp_multi_step,
    make_tp_train_step,
    replicate_tp,
    shard_tp_batch,
    shard_tp_state,
)
from trigenicinteractionpredictor_tpu_torch.config import (
    Config,
    EngineConfig,
    TrainConfig,
)
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

ATOL, RTOL, FIT_ATOL = 1e-5, 1e-5, 2e-5
N, G, K, S = 512, 24, 8, 2
WORLDS = {"model2": (2, 1), "model2_data2": (2, 2)}
FIT_TRAIN = dict(k=K, sweeps=6, samples=S, likelihood_freq=3, seed=1,
                 anneal_beta0=0.4, anneal_sweeps=4)

WORKER = torch_ranks.WORKER_PRELUDE + r"""
import json
from trigenicinteractionpredictor_tpu_torch.config import (
    Config, EngineConfig, MeshConfig, TrainConfig)
from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import state_from_numpy
from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
from trigenicinteractionpredictor_tpu_torch.parallel import sharded_em as se
from trigenicinteractionpredictor_tpu_torch.parallel import tensor_parallel as tp
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

inp, out, model, data = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
z = np.load(inp)
mesh = make_mesh(data=data, model=model)
lo, hi = se.shard_rows(len(z["ratings"]), mesh)
batch = make_batch(z["triplets"][lo:hi], z["ratings"][lo:hi], z["weights"][lo:hi], "cpu")
deg = torch.as_tensor(z["degrees"])
states = tp.shard_tp_state(state_from_numpy(z["theta"], z["p"]), mesh)
res = {}
st, ll = tp.tp_step(states, batch, deg, mesh, row_chunk=100)
g = tp.gather_tp_states(st, mesh)
res.update(step_theta=g.theta, step_p=g.p, step_ll=se.gather_loglik(ll, mesh))
st, hist = tp.tp_multi_step(states, batch, deg, mesh, len(z["betas"]), betas=z["betas"])
g = tp.gather_tp_states(st, mesh)
res.update(anneal_theta=g.theta, anneal_p=g.p, anneal_ll=hist)
res["ll"] = se.gather_loglik(tp.tp_likelihood(states, batch, mesh, row_chunk=100), mesh)

ds = TripletDataset(triplets=z["triplets"], ratings=z["ratings"], weights=z["weights"],
                    n_genes=int(z["n_genes"]), n_ratings=2)
cfg = Config(train=TrainConfig(**json.loads(str(z["fit_train"]))),
             mesh=MeshConfig(data=data, model=model), engine=EngineConfig(backend="jnp"))
log = JsonlLogger(out + f".events{RANK}.jsonl", echo=False)
r = fit(cfg, ds, device="cpu", logger=log)
log.close()
res.update(fit_theta=r.states.theta, fit_p=r.states.p, fit_ll=r.final_loglik,
           fit_trace=r.ll_trace, fit_sweeps=np.array([r.sweeps_run]),
           fit_kernel=np.array(r.dispatch["kernel"]))
if RANK == 0:
    np.savez(out, **{k: v.numpy() if torch.is_tensor(v) else v for k, v in res.items()})
shutdown()
"""


def _inputs():
    ds, _, _ = sample_synthetic_dataset(N, G, 4, n_ratings=2, seed=7)
    rng = np.random.default_rng(3)
    import json

    return dict(
        triplets=ds.triplets, ratings=ds.ratings, weights=ds.weights,
        degrees=ds.degrees(), n_genes=np.int64(G),
        theta=rng.dirichlet(np.ones(K), size=(S, G)).astype(np.float32),
        p=rng.dirichlet(np.ones(2), size=(S, K, K, K)).astype(np.float32),
        betas=np.asarray([0.4, 0.7, 1.0], np.float32),
        fit_train=np.array(json.dumps(FIT_TRAIN)),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = {name: torch_ranks.start_world(str(script), model * data,
                                           [tmp / "in.npz", tmp / f"{name}.npz", model, data])
             for name, (model, data) in WORLDS.items()}
    for p in procs.values():
        torch_ranks.wait(p)
    return {name: (inp, dict(np.load(tmp / f"{name}.npz")), tmp) for name in WORLDS}


def _jax(inp, name):
    model, data = WORLDS[name]
    mesh = make_tp_mesh(model=model, data=data)
    batch = shard_tp_batch(mesh, JBatch(triplets=jnp.asarray(inp["triplets"]),
                                        ratings=jnp.asarray(inp["ratings"]),
                                        weights=jnp.asarray(inp["weights"])))
    states = shard_tp_state(mesh, JState(theta=jnp.asarray(inp["theta"]),
                                         p=jnp.asarray(inp["p"])))
    return mesh, batch, states, replicate_tp(mesh, jnp.asarray(inp["degrees"]))


@pytest.mark.parametrize("name", list(WORLDS))
def test_tp_step_matches_jax(runs, name):
    inp, out, _ = runs[name]
    mesh, batch, states, deg = _jax(inp, name)
    want, want_ll = make_tp_train_step(mesh)(states, batch, deg)
    np.testing.assert_allclose(out["step_ll"], np.asarray(want_ll), rtol=RTOL)
    np.testing.assert_allclose(out["step_theta"], np.asarray(want.theta), atol=ATOL)
    np.testing.assert_allclose(out["step_p"], np.asarray(want.p), atol=ATOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_tp_annealed_multi_step_matches_jax(runs, name):
    """The DAEM betas commute with the l-split: (theta^beta, p^beta) per
    block, the unpowered carry normalized."""
    inp, out, _ = runs[name]
    mesh, batch, states, deg = _jax(inp, name)
    step = make_tp_multi_step(mesh, len(inp["betas"]), annealed=True)
    want, hist = step(states, batch, deg, replicate_tp(mesh, jnp.asarray(inp["betas"])))
    np.testing.assert_allclose(out["anneal_ll"], np.asarray(hist), rtol=RTOL)
    np.testing.assert_allclose(out["anneal_theta"], np.asarray(want.theta), atol=ATOL)
    np.testing.assert_allclose(out["anneal_p"], np.asarray(want.p), atol=ATOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_tp_likelihood_matches_jax(runs, name):
    inp, out, _ = runs[name]
    mesh, batch, states, _ = _jax(inp, name)
    np.testing.assert_allclose(out["ll"], np.asarray(make_tp_likelihood(mesh)(states, batch)),
                               rtol=RTOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_tp_fit_matches_replicated_fit(runs, name):
    """``fit`` with mesh.model = 2 (annealed, K = 8) equals the port's
    replicated one-process fit of the same seed, and records ``jnp-tp``."""
    import json

    from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset

    inp, out, tmp = runs[name]
    ds = TripletDataset(triplets=inp["triplets"], ratings=inp["ratings"],
                        weights=inp["weights"], n_genes=G, n_ratings=2)
    cfg = Config(train=TrainConfig(**FIT_TRAIN), engine=EngineConfig(backend="jnp"))
    rep = fit(cfg, ds, device="cpu", logger=JsonlLogger(None, echo=False))
    assert str(out["fit_kernel"]) == "jnp-tp"
    assert int(out["fit_sweeps"][0]) == rep.sweeps_run
    np.testing.assert_allclose(out["fit_ll"], rep.final_loglik, rtol=RTOL)
    np.testing.assert_allclose(out["fit_trace"], rep.ll_trace, rtol=RTOL)
    np.testing.assert_allclose(out["fit_theta"], rep.states.theta.numpy(), atol=FIT_ATOL)
    np.testing.assert_allclose(out["fit_p"], rep.states.p.numpy(), atol=FIT_ATOL)
    events = [json.loads(line) for line in open(tmp / f"{name}.npz.events0.jsonl")]
    backend = next(e for e in events if e["event"] == "backend")
    assert backend["kernel"] == "jnp-tp" and backend["model_shards"] == 2
