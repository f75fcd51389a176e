"""The port's compute-integrity sentinel (utils/integrity.py), on the CPU.

On the CPU ``check_em_integrity`` is a no-op, as the reference's is; to
drive its probes, caches and verdicts here, the tests make it treat the
CPU as the device under test (``_on_host``), where every kernel wrapper
runs its plain version.  The reference is not imported: the sentinel
checks the port against itself on the host, and its tolerance is the
reference's 5e-3 (utils/integrity.py:47).
"""

import json
import shutil

import pytest
import torch

from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.ops import (
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_k,
    score,
)
from trigenicinteractionpredictor_tpu_torch.train import trainer
from trigenicinteractionpredictor_tpu_torch.utils import integrity
from trigenicinteractionpredictor_tpu_torch.utils.integrity import ComputeIntegrityError

torch.set_num_threads(2)


@pytest.fixture
def sentinel(tmp_path, monkeypatch):
    """The sentinel with its disk cache in tmp_path, no in-process verdicts,
    and the CPU taken as the device under test."""
    monkeypatch.setattr(integrity, "CACHE_PATH", str(tmp_path / "verdicts.json"))
    monkeypatch.setattr(integrity, "_on_host", lambda dev: False)
    integrity.clear_cache()
    yield integrity
    integrity.clear_cache()


def _corrupt_k1(monkeypatch):
    real = em_bdr.em_ensemble_stats

    def corrupt(thetas, ps, batch):
        out = real(thetas, ps, batch)
        return out._replace(theta_hat=out.theta_hat * 0.9)

    monkeypatch.setattr(em_bdr, "em_ensemble_stats", corrupt)


def test_cpu_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.setattr(integrity, "CACHE_PATH", str(tmp_path / "verdicts.json"))
    runs = integrity.probe_runs
    assert integrity.check_em_integrity("cpu", 3) is True
    assert integrity.check_em_integrity(torch.device("cpu"), 2) is True
    assert integrity.probe_runs == runs
    assert not (tmp_path / "verdicts.json").exists()


def test_probe_shapes_lie_in_their_kernels_ranges():
    """Every probe of the default shape fits its kernel's host plan; arity
    2 probes the plain sweep only; the probes cover every kernel route
    dispatch picks."""
    ps = integrity.probes(3)
    assert [p.name for p in ps] == ["plain", "K1", "K3", "K7", "K4", "K5", "K6", "K2"]
    assert {p.kernel for p in ps} >= {em_bdr.KERNEL_NAME, em_large_k.KERNEL_NAME,
                                      em_hybrid.KERNEL_NAME, em_bdg.KERNEL_NAME,
                                      em_bd.KERNEL_NAME, score.KERNEL_NAME}
    shapes = {p.name: p.shape for p in ps}
    for name in ("K1", "K5", "K6"):  # K5 and K6 run K5a, which takes K1's plan
        assert em_bdr.sweep_plan(shapes[name]["k"], shapes[name]["r"]) is not None
    assert em_large_k.sweep_plan(shapes["K3"]["k"], shapes["K3"]["r"]) is not None
    assert shapes["K3"] == dict(n=2048, g=512, k=50, r=2, s=1)
    assert shapes["K7"] == dict(n=4096, g=3072, k=25, r=2, s=2)
    assert em_large_k.sweep_plan(shapes["K7"]["k"], shapes["K7"]["r"]) is not None
    assert em_bdg.bdg_plan(shapes["K4"]["k"], shapes["K4"]["r"]) is not None
    assert shapes["K4"]["s"] == shapes["K5"]["s"] == 2 and shapes["K6"]["s"] == 1
    assert score.score_plan(shapes["K2"]["k"]) is not None
    assert all(1 <= p.shape["s"] <= 65535 for p in ps[1:])
    assert [p.name for p in integrity.probes(2)] == ["plain"]


@pytest.mark.parametrize("arity", [3, 2])
def test_probes_pass_with_the_plain_versions(arity):
    """On the CPU every wrapper runs its plain version: each probe passes
    with an error at rounding level (the plan routes sum in another
    order)."""
    results = integrity.run_probes("cpu", arity)
    assert all(r.ok and r.error is None for r in results), results
    assert max(r.err for r in results) < 1e-5


def test_corrupt_output_fails_the_probe_and_the_check(sentinel, monkeypatch):
    """theta_hat x 0.9 from K1 fails its probe (and only it); the check
    raises naming it, and the FAIL verdict is cached on disk."""
    _corrupt_k1(monkeypatch)
    with pytest.raises(ComputeIntegrityError, match="K1 .*cuda-em-sweep"):
        sentinel.check_em_integrity("cpu", 3)
    failed = [r.name for r in sentinel.last_probes if not r.ok]
    assert failed == ["K1"]
    k1 = next(r for r in sentinel.last_probes if r.name == "K1")
    assert k1.error is None and 0.05 < k1.err < 0.2
    assert list(json.load(open(sentinel.CACHE_PATH)).values()) == [False]
    with pytest.raises(ComputeIntegrityError):  # the in-process verdict too
        sentinel.check_em_integrity("cpu", 3)


def test_a_tampered_probe_fails():
    """run_probe's tamper hook (what chip_smoke.py feeds a corrupt output
    through) fails the probe without raising."""
    k1 = integrity.probes(3)[1]
    bad = integrity.run_probe(k1, "cpu",
                              tamper=lambda out: out._replace(theta_hat=out.theta_hat * 0.9))
    assert not bad.ok and bad.error is None and bad.err > integrity._TOL


def test_an_exception_in_plumbing_fails_the_probe(sentinel, monkeypatch):
    """A plan that raises while it is built fails its probe: no warning-and-pass."""

    def broken(*args, **kwargs):
        raise RuntimeError("plan builder broke")

    monkeypatch.setattr(em_bdg, "device_g1_order", broken)
    k4 = next(p for p in integrity.probes(3) if p.name == "K4")
    res = integrity.run_probe(k4, "cpu")
    assert not res.ok and "plan builder broke" in res.error
    with pytest.raises(ComputeIntegrityError, match="plan builder broke"):
        sentinel.check_em_integrity("cpu", 3)


def test_a_cached_fail_raises_and_names_the_file(sentinel, monkeypatch):
    """A FAIL on disk raises in a fresh process state, without probing
    again, and says which file to delete; a PASS on disk skips the probes
    too."""
    with monkeypatch.context() as m:
        _corrupt_k1(m)
        with pytest.raises(ComputeIntegrityError):
            sentinel.check_em_integrity("cpu", 3)
    sentinel.clear_cache()
    runs = sentinel.probe_runs
    with pytest.raises(ComputeIntegrityError, match="delete .*verdicts.json"):
        sentinel.check_em_integrity("cpu", 3)
    assert sentinel.probe_runs == runs
    # another shape has no verdict yet: it probes, passes, and is cached
    assert sentinel.check_em_integrity("cpu", 3, n=4096)
    assert sentinel.probe_runs == runs + 1
    sentinel.clear_cache()
    assert sentinel.check_em_integrity("cpu", 3, n=4096)
    assert sentinel.probe_runs == runs + 1
    verdicts = json.load(open(sentinel.CACHE_PATH))
    assert sorted(verdicts.values()) == [False, True]
    assert all(f"tol={integrity._TOL}" in key for key in verdicts)


def test_fingerprint_follows_the_kernel_sources(tmp_path):
    """The cache key's fingerprint covers csrc/*.cu, *.cuh and ops/*.py: a
    copy of the package gives the same one, a changed byte another."""
    pkg = integrity._PKG
    copy = tmp_path / "pkg"
    shutil.copytree(pkg / "ops", copy / "ops", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(pkg / "csrc", copy / "csrc")
    base = integrity.code_fingerprint(copy)
    assert base == integrity.code_fingerprint()
    for name in ("csrc/em_rsorted.cu", "csrc/em_tile.cuh", "ops/em_bdr.py"):
        path = copy / name
        data = path.read_bytes()
        path.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
        assert integrity.code_fingerprint(copy) != base, name
        path.write_bytes(data)
    assert integrity.code_fingerprint(copy) == base


def test_fit_runs_the_sentinel_before_any_sweep(monkeypatch):
    """fit calls check_em_integrity(device, arity) before its first sweep:
    a failing verdict stops it with no stats call."""
    from trigenicinteractionpredictor_tpu_torch import Config

    seen = []

    def failing(dev, arity):
        seen.append((str(dev), arity))
        raise ComputeIntegrityError("probe failed")

    def stats(*args):
        raise AssertionError("a sweep ran before the sentinel")

    monkeypatch.setattr(trainer, "check_em_integrity", failing)
    ds, _, _ = sample_synthetic_dataset(256, 20, 2, seed=1)
    with pytest.raises(ComputeIntegrityError):
        trainer.fit(Config(), ds, device="cpu", stats_fn=stats)
    assert seen == [("cpu", 3)]
