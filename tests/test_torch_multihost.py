"""The port's fit, resume and work units over several gloo ranks on the CPU,
against the same job in one process (counterpart of the reference's
tests/test_multihost.py, on real processes).

Three worlds start together: 2 ranks (data 2) run a fit that stops early,
a fit cut at 10 sweeps and resumed to 20, a fit whose rank 0 rows lack a
gene, and a stepwise fit; 4 ranks (data 2 x ensemble 2) run an annealed
fit with a split-merge round; and torchrun runs the CLI's ``sweep`` on 2
ranks.  Tolerances: rtol 1e-5 on L and atol 1e-5 on theta (the ranks sum
the stats in another order than one process does); the stepwise fit rtol
1e-4 (its EMA compounds that order over 12 updates).  The refusals run in
this process.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import torch_ranks
from trigenicinteractionpredictor_tpu_torch.cli import main
from trigenicinteractionpredictor_tpu_torch.config import Config, MeshConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.parallel import distributed
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import Mesh
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

torch.set_num_threads(1)

RTOL, ATOL, STEPWISE_RTOL = 1e-5, 1e-5, 1e-4
QUIET = JsonlLogger(None, echo=False)
TSV = os.path.join(torch_ranks.REPO, "datasets", "example_trigenic.tsv")
BASE = dict(k=3, samples=2, likelihood_freq=5, seed=4)
JOBS = {  # name -> (dataset, train config, fit keywords)
    "early": ("main", dict(BASE, sweeps=80, tol=1.5, checkpoint_every=10), {"ckpt": "early"}),
    "part": ("main", dict(BASE, sweeps=10, checkpoint_every=5), {"ckpt": "part"}),
    "resumed": ("main", dict(BASE, sweeps=20), {"ckpt": "resumed", "resume": "part"}),
    "gap": ("gap", dict(BASE, sweeps=20), {}),
    "stepwise": ("big", dict(BASE, sweeps=3, likelihood_freq=1, minibatch=512,
                             stream_groups=2), {}),
    "knobs": ("main", dict(BASE, sweeps=20, samples=4, anneal_beta0=0.5, anneal_sweeps=8,
                           smem_rounds=1, smem_sweeps=5), {}),
    "stepwise4": ("big", dict(BASE, sweeps=2, samples=4, likelihood_freq=1, minibatch=512,
                              checkpoint_every=1), {"ckpt": "stepwise4"}),
}
WORLDS = {"data2": ((2, 1), ["early", "part", "resumed", "gap", "stepwise"]),
          "data2_ensemble2": ((2, 2), ["knobs", "stepwise4"])}
UNITS = dict(BASE, sweeps=10)
SWEEP_ARGS = ["--k-grid", "2,3", "-i", "10", "-s", "2", "-n", "5", "--device", "cpu"]

WORKER = torch_ranks.WORKER_PRELUDE + r"""
import json, os
from trigenicinteractionpredictor_tpu_torch.config import Config, MeshConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.train import trainer
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

inp, out = sys.argv[1], sys.argv[2]
spec = json.loads(sys.argv[3])
z = np.load(inp)
saves = []
real_save = trainer.save_checkpoint
def counted_save(path, *a, **kw):
    saves.append(os.path.basename(path))
    return real_save(path, *a, **kw)
trainer.save_checkpoint = counted_save

res = {}
for name, (data_name, train, kw) in spec["jobs"].items():
    ds = TripletDataset(triplets=z[data_name + "_triplets"], ratings=z[data_name + "_ratings"],
                        weights=z[data_name + "_weights"], n_genes=int(z["n_genes"]),
                        n_ratings=2)
    data, ens = spec["mesh"]
    cfg = Config(train=TrainConfig(**train), mesh=MeshConfig(data=data, ensemble=ens))
    ck = lambda tag: os.path.join(os.path.dirname(out), tag + ".ckpt.npz")
    with JsonlLogger(f"{out}.{name}.events{RANK}.jsonl", echo=False) as log:
        r = trainer.fit(cfg, ds, device="cpu", logger=log,
                        checkpoint_path=ck(kw["ckpt"]) if "ckpt" in kw else None,
                        resume=ck(kw["resume"]) if "resume" in kw else None)
    res.update({name + "_ll": r.final_loglik, name + "_trace": r.ll_trace,
                name + "_sweeps": np.array([r.sweeps_run]), name + "_theta": r.states.theta,
                name + "_p": r.states.p})
res["saves"] = np.array(saves)
if "units" in spec:
    # One mesh over every rank: each rank runs every unit; the origin writes.
    from trigenicinteractionpredictor_tpu_torch.parallel.mesh import make_mesh
    from trigenicinteractionpredictor_tpu_torch.train.driver import run_units

    ds = TripletDataset(triplets=z["main_triplets"], ratings=z["main_ratings"],
                        weights=z["main_weights"], n_genes=int(z["n_genes"]), n_ratings=2)
    ucfg = Config(train=TrainConfig(**spec["units"]), out_dir=os.path.dirname(out) + "/units")
    recs = run_units(ucfg, ds, k_grid=[2, 3], device="cpu", mesh=make_mesh(data=spec["mesh"][0]))
    res["units_ll"] = np.array([r["ll_per_sample"] for r in recs])
np.savez(f"{out}.rank{RANK}.npz", **{k: v.numpy() if torch.is_tensor(v) else v
                                     for k, v in res.items()})
shutdown()
"""


def _datasets():
    main_ds, _, _ = sample_synthetic_dataset(800, 30, 3, n_ratings=2, seed=21)
    # Rows with the last gene go last, so rank 0's half of them holds none.
    has = (main_ds.triplets == 29).any(axis=1)
    gap = main_ds.select(np.concatenate([np.flatnonzero(~has), np.flatnonzero(has)]))
    big, _, _ = sample_synthetic_dataset(2048, 30, 3, n_ratings=2, seed=22)
    return {"main": main_ds, "gap": gap, "big": big}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world started together: ({world: [rank outputs]}, datasets, tmp)."""
    tmp = tmp_path_factory.mktemp("multihost")
    dsets = _datasets()
    np.savez(tmp / "in.npz", n_genes=np.int64(30),
             **{f"{n}_{f}": getattr(d, f) for n, d in dsets.items()
                for f in ("triplets", "ratings", "weights")})
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = {}
    for world, (mesh, jobs) in WORLDS.items():
        (tmp / world).mkdir()
        spec = {"mesh": mesh, "jobs": {j: JOBS[j] for j in jobs}}
        if world == "data2":
            spec["units"] = UNITS
        spec = json.dumps(spec)
        procs[world] = torch_ranks.start_world(
            str(script), mesh[0] * mesh[1], [tmp / "in.npz", tmp / world / "out", spec])
    procs["cli"] = torch_ranks.start_torchrun(
        ["-m", "trigenicinteractionpredictor_tpu_torch", "sweep", "-f", TSV, *SWEEP_ARGS,
         "-o", tmp / "cli", "--dist-timeout", str(torch_ranks.GROUP_TIMEOUT_S)], 2)
    outs = {name: torch_ranks.wait(p) for name, p in procs.items()}
    ranks = {world: [dict(np.load(tmp / world / f"out.rank{r}.npz"))
                     for r in range(mesh[0] * mesh[1])]
             for world, (mesh, _) in WORLDS.items()}
    return ranks, dsets, tmp, outs["cli"][0]


def _one_process(dsets, name, tmp, **kw):
    data_name, train, _ = JOBS[name]
    return fit(Config(train=TrainConfig(**train)), dsets[data_name], device="cpu",
               logger=QUIET, **kw)


def _same_fit(out, name, ref, rtol=RTOL):
    assert int(out[name + "_sweeps"][0]) == ref.sweeps_run
    np.testing.assert_allclose(out[name + "_trace"], ref.ll_trace, rtol=rtol)
    np.testing.assert_allclose(out[name + "_ll"], ref.final_loglik, rtol=rtol)
    np.testing.assert_allclose(out[name + "_theta"], ref.states.theta.numpy(),
                               atol=ATOL if rtol == RTOL else 10 * ATOL)


def test_two_rank_fit_equals_one_process_and_rank_0_writes(runs):
    """data 2: the same early-stop sweep, L trace, final L and states as one
    process; both ranks return the same result; only rank 0 saves, and its
    checkpoint holds the gathered states."""
    ranks, dsets, tmp, _ = runs
    # A checkpoint flushes the trace at once, so the stop sweep depends on
    # checkpoint_every: the one-process fit checkpoints too.
    ref = _one_process(dsets, "early", tmp, checkpoint_path=str(tmp / "one.ckpt.npz"))
    assert ref.sweeps_run < JOBS["early"][1]["sweeps"]  # it did stop early
    r0, r1 = ranks["data2"]
    _same_fit(r0, "early", ref)
    for key in ("early_ll", "early_trace", "early_theta", "early_p", "early_sweeps"):
        np.testing.assert_array_equal(r0[key], r1[key])
    assert len(r1["saves"]) == 0 and "early.ckpt.npz" in set(r0["saves"])
    with np.load(tmp / "data2" / "early.ckpt.npz") as ck:
        assert int(ck["sweep"]) == ref.sweeps_run
        np.testing.assert_array_equal(ck["theta"], r0["early_theta"])
    assert not glob.glob(str(tmp / "data2" / "*.tmp*"))


def test_two_rank_resume_equals_the_uninterrupted_fit(runs):
    """A checkpoint written at sweep 10 by the 2-rank fit, resumed on 2
    ranks to sweep 20, equals one process's uninterrupted 20 sweeps."""
    ranks, dsets, tmp, _ = runs
    ref = fit(Config(train=TrainConfig(**JOBS["resumed"][1])), dsets["main"], device="cpu",
              logger=QUIET)
    _same_fit(ranks["data2"][0], "resumed", ref)


def test_a_shard_without_a_gene_keeps_its_global_row(runs):
    """Rank 0's rows lack gene 29, yet rank 0's own theta row for it equals
    the one-process fit's: the sweep normalizes with the global degrees."""
    ranks, dsets, tmp, _ = runs
    assert not (dsets["gap"].triplets[:400] == 29).any()
    assert (dsets["gap"].triplets[400:] == 29).any()
    ref = _one_process(dsets, "gap", tmp)
    got = ranks["data2"][0]["gap_theta"]
    np.testing.assert_allclose(got[:, 29], ref.states.theta[:, 29].numpy(), atol=ATOL)
    _same_fit(ranks["data2"][0], "gap", ref)


def test_two_rank_stepwise_fit_equals_one_process(runs):
    """Stepwise EM over data 2 (each rank a slice of every minibatch, stats
    and weights summed over data) against the same fit in one process."""
    ranks, dsets, tmp, _ = runs
    ref = _one_process(dsets, "stepwise", tmp)
    _same_fit(ranks["data2"][0], "stepwise", ref, rtol=STEPWISE_RTOL)


def test_four_rank_annealed_smem_fit_equals_one_process(runs):
    """data 2 x ensemble 2, annealing and a split-merge round: the same
    sweeps and best L per check; the final lanes equal as a set (an
    accepted round patches an argmin lane, which float32 ties may move)."""
    ranks, dsets, tmp, _ = runs
    ref = _one_process(dsets, "knobs", tmp)
    for out in ranks["data2_ensemble2"]:
        assert int(out["knobs_sweeps"][0]) == ref.sweeps_run
        np.testing.assert_allclose(out["knobs_trace"].max(axis=1), ref.ll_trace.max(axis=1),
                                   rtol=RTOL)
        np.testing.assert_allclose(np.sort(out["knobs_ll"]), np.sort(ref.final_loglik),
                                   rtol=RTOL)


def test_four_rank_stepwise_fit_checkpoints_the_gathered_ensemble(runs):
    """Stepwise EM over data 2 x ensemble 2 equals one process; its
    checkpoint holds all 4 restarts and their EMA, and resumes in one
    process to the same next epoch as the uninterrupted fit."""
    ranks, dsets, tmp, _ = runs
    ref = _one_process(dsets, "stepwise4", tmp)
    for out in ranks["data2_ensemble2"]:
        _same_fit(out, "stepwise4", ref, rtol=STEPWISE_RTOL)
    ck = tmp / "data2_ensemble2" / "stepwise4.ckpt.npz"
    with np.load(ck) as z:
        assert z["theta"].shape[0] == 4 and z["extra_ema_theta_hat"].shape[0] == 4
        assert float(z["extra_stepwise_t"]) == 2 * 4  # 2 epochs of 4 minibatches
    train = dict(JOBS["stepwise4"][1], sweeps=3, checkpoint_every=0)
    resumed = fit(Config(train=TrainConfig(**train)), dsets["big"], device="cpu",
                  logger=QUIET, resume=str(ck))
    whole = fit(Config(train=TrainConfig(**train)), dsets["big"], device="cpu", logger=QUIET)
    np.testing.assert_allclose(resumed.final_loglik, whole.final_loglik, rtol=STEPWISE_RTOL)


def test_two_rank_cli_sweep_equals_one_process(runs, tmp_path, capsys):
    """``sweep`` under torchrun on 2 ranks: each rank runs one unit on its
    own device and logs to its own events file; rank 0 merges the report
    after the barrier, and it equals the one-process job's."""
    _, _, tmp, cli_out = runs
    assert main(["sweep", "-f", TSV, *SWEEP_ARGS, "-o", str(tmp_path)]) == 0
    want = json.load(open(tmp_path / "report.json"))
    got = json.load(open(tmp / "cli" / "report.json"))
    for key, value in want["summary"].items():
        if isinstance(value, float):
            assert got["summary"][key] == pytest.approx(value, rel=RTOL)
        elif key != "best_auc_per_fold":
            assert got["summary"][key] == value
    assert [u["unit"] for u in got["units"]] == [u["unit"] for u in want["units"]]
    for g, w in zip(got["units"], want["units"]):
        np.testing.assert_allclose(g["ll_per_sample"], w["ll_per_sample"], rtol=RTOL)
        np.testing.assert_allclose(g["heldout_loglik"], w["heldout_loglik"], rtol=RTOL)
        assert g["sweeps"] == w["sweeps"] and g["dispatch"]["kernel"] == "torch"
    assert sorted(u["process"] for u in got["units"]) == [0, 1]
    for rank in (0, 1):
        events = [json.loads(line) for line in open(tmp / "cli" / f"events_p{rank}.jsonl")]
        assert len([e for e in events if e["event"] == "unit_start"]) == 1
        assert any(e["event"] == "local_mesh" for e in events)
    assert cli_out.count('"mean_auc_selected"') == 1  # rank 0 alone prints the summary


def test_units_on_a_mesh_over_every_rank_run_on_every_rank(runs):
    """run_units with a mesh that spans the ranks: every rank runs every
    unit on it (no round-robin, which would leave ranks waiting in each
    other's collectives); the records equal one process's; the mesh's
    origin alone writes the DONE markers."""
    ranks, dsets, tmp, _ = runs
    from trigenicinteractionpredictor_tpu_torch.train import driver

    one = driver.run_units(Config(train=TrainConfig(**UNITS), out_dir=str(tmp / "units1")),
                           dsets["main"], k_grid=[2, 3], device="cpu")
    want = np.array([r["ll_per_sample"] for r in one])
    for out in ranks["data2"]:
        np.testing.assert_allclose(out["units_ll"], want, rtol=RTOL)
    units = tmp / "data2" / "units" / "units"
    assert sorted(p.name for p in units.glob("*.json")) == ["fold0_k2.json", "fold0_k3.json"]
    assert sorted(p.name for p in (tmp / "data2" / "units").glob("events_p*.jsonl")) == [
        "events_p0.jsonl", "events_p1.jsonl"]


@pytest.mark.parametrize("rsort", [False, True])
def test_a_rank_preps_its_slice_of_every_minibatch(rsort):
    """StreamPrep with ``shard`` = (i, 2) gives rank i's slice of the whole
    group's prep: its columns of each minibatch, and with the rating sort
    shard i of the two-shard layout (tile table too)."""
    from trigenicinteractionpredictor_tpu_torch.train.stream_prep import StreamPrep

    ds = _datasets()["big"]
    mb, tile, group = 512, 64, 2
    ft = mb // 2 // tile + 2 if rsort else 0
    base = {"seed": 3, "n": ds.n_rows, "n_padded": 2048, "mb": mb, "group": group,
            "arity": 3, "rsort": rsort, "n_ratings": 2, "tile": tile if rsort else 0,
            "n_tiles": ft}
    width = ft * tile if rsort else mb // 2
    whole = StreamPrep(ds, dict(base, mb_b=2 * width, n_shards=2), workers=1)
    want = whole.prep_group(1, 1)
    for i in (0, 1):
        part = StreamPrep(ds, dict(base, mb_b=width, n_shards=1, shard=(i, 2)), workers=1)
        got = part.prep_group(1, 1)
        assert sorted(got) == sorted(want)
        for key, arr in got.items():
            w = ft if key == "tiler" else width
            np.testing.assert_array_equal(arr, want[key][:, i * w:(i + 1) * w])


def _digenic(n=300, g=20):
    ds, _, _ = sample_synthetic_dataset(n, g, 3, n_ratings=2, seed=3, arity=2)
    return ds


def _mesh(ensemble=1, model=1):
    return Mesh(shape={"ensemble": ensemble, "model": model, "data": 1},
                coords={"ensemble": 0, "model": 0, "data": 0})


@pytest.mark.parametrize(
    "mesh,train,arity,match",
    [
        (_mesh(ensemble=2), dict(samples=3), 3, "samples=3 must divide by ensemble axis 2"),
        (_mesh(model=2), dict(k=3), 3, "k=3 must divide by the model axis 2"),
        (_mesh(model=2), dict(k=4), 2, "tensor parallelism is trigenic-only"),
        (_mesh(model=2), dict(k=4, minibatch=64), 3,
         "stepwise EM does not compose with tensor parallelism"),
    ],
)
def test_fit_refuses_the_reference_mesh_errors(mesh, train, arity, match):
    ds = _digenic() if arity == 2 else _datasets()["main"]
    cfg = Config(train=TrainConfig(**dict(dict(k=3, sweeps=2, samples=2), **train)))
    with pytest.raises(ValueError, match=match):
        fit(cfg, ds, device="cpu", logger=QUIET, mesh=mesh)


@pytest.mark.parametrize(
    "env,device,backend,match",
    [
        ({"WORLD_SIZE": "2", "RANK": "0"}, "cpu", "nccl", "nccl backend needs CUDA"),
        ({"WORLD_SIZE": "2", "RANK": "0", "LOCAL_WORLD_SIZE": "2"}, "cuda:0", "nccl",
         "--dist-backend gloo to share a card"),
        ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}, "cuda", None,
         "--device cuda:0 --dist-backend gloo"),
    ],
)
def test_launch_refusals(monkeypatch, env, device, backend, match):
    """NCCL on the CPU, NCCL with two ranks on one card, and a LOCAL_RANK
    with no GPU of its own are refused before any process group starts."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(torch_ranks.free_port()))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if torch.cuda.device_count() > int(env.get("LOCAL_RANK", "0")) and backend is None:
        pytest.skip("this host has a GPU for that LOCAL_RANK")
    with pytest.raises(ValueError, match=match):
        distributed.maybe_initialize(device=device, backend=backend)
    assert not torch.distributed.is_initialized()


def test_a_local_mesh_must_hold_the_ensemble_and_model_axes(tmp_path, monkeypatch):
    """Units across processes fit on one device each: cfg.mesh.ensemble > 1
    cannot fit there (the reference's driver refusal)."""
    from trigenicinteractionpredictor_tpu_torch.train import driver

    monkeypatch.setattr(driver, "topology",
                        lambda: distributed.ProcessTopology(0, 2, 0))
    cfg = Config(train=TrainConfig(k=3, sweeps=2, samples=2),
                 mesh=MeshConfig(ensemble=2), out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="local devices do not divide"):
        driver.run_units(cfg, _datasets()["main"], k_grid=[3], device="cpu")


def test_one_process_topology_needs_no_group():
    assert distributed.topology() == distributed.ProcessTopology(0, 1, 0)
    assert distributed.maybe_initialize(device="cpu").process_count == 1
    assert not torch.distributed.is_initialized()
