"""The port's parity-readiness gate (``parity.py``, ``verify-parity``) on the
CPU, against the reference's gate on the checked-in example dataset: ports
of the three tests of the reference's tests/test_parity_gate.py, the
fingerprint and dataset digests equal to the reference's, and the CLI
with and without ``--no-fit``."""

import json
import os

import numpy as np
import pytest

from trigenicinteractionpredictor_tpu import parity as jparity
from trigenicinteractionpredictor_tpu.config import Config as JConfig
from trigenicinteractionpredictor_tpu.config import SplitConfig as JSplit
from trigenicinteractionpredictor_tpu.config import TrainConfig as JTrain
from trigenicinteractionpredictor_tpu_torch.config import Config, SplitConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.native import binding
from trigenicinteractionpredictor_tpu_torch.parity import (
    loader_fingerprint,
    parity_artifact,
    reference_mount_status,
    run_verify_parity,
)

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "datasets", "example_trigenic.tsv")
TRAIN = dict(k=3, sweeps=30, samples=2, likelihood_freq=10)


@pytest.mark.parametrize("mount", ["none", "missing", "empty", "filled"])
def test_reference_mount_status_shape(tmp_path, mount):
    path = {"none": None, "missing": str(tmp_path / "absent")}.get(mount, str(tmp_path))
    if mount == "filled":
        os.makedirs(tmp_path / "src")
        for name in ("b.py", os.path.join("src", "a.py")):
            open(tmp_path / name, "w").close()
    st = reference_mount_status(path)
    assert {"path", "present", "n_files", "files"} <= set(st)
    assert st["path"] == path and st["present"] == (mount in ("empty", "filled"))
    assert st["n_files"] == (2 if mount == "filled" else 0)
    if mount == "filled":
        assert st["files"] == ["b.py", os.path.join("src", "a.py")]
        want = jparity.reference_mount_status(path)
        assert {k: st[k] for k in want if k != "note"} == {k: want[k] for k in want
                                                           if k != "note"}


def test_loader_fingerprint_counts():
    before = binding.parses
    fp = loader_fingerprint(EXAMPLE)
    assert binding.parses > before  # the trigenic modes load natively
    assert fp["n_raw_rows"] > 0
    assert sum(fp["rows_by_mutant_type"].values()) == fp["n_raw_rows"]
    tri = fp["modes"]["trigenic/abs"]
    assert tri["rows"] > 0 and tri["genes"] > 2
    assert 0 <= tri["positives"] <= tri["rows"]
    # negative-tau mode can only shrink the positive set
    assert fp["modes"]["trigenic/negative"]["positives"] <= tri["positives"]
    assert tri["dedup_delta"] >= 0
    # digenic mode extracts pair rows from the same file
    assert fp["modes"]["digenic/abs"]["rows"] > 0


def test_loader_fingerprint_equals_reference():
    assert loader_fingerprint(EXAMPLE) == jparity.loader_fingerprint(EXAMPLE)


def test_full_gate_end_to_end(tmp_path):
    cfg = Config(train=TrainConfig(**TRAIN), split=SplitConfig(test_fraction=0.25, seed=0))
    report = run_verify_parity(EXAMPLE, cfg, str(tmp_path), device="cpu")
    art = report["artifact"]
    assert np.isfinite(art["converged"]["train_loglik_best"])
    assert 0.0 <= art["converged"]["auc"] <= 1.0
    assert len(art["predictions_head"]) > 0
    # artifacts on disk: JSON + text dumps + scores TSV
    assert (tmp_path / "verify_parity.json").exists()
    assert (tmp_path / "test_scores.tsv").exists()
    assert (tmp_path / "params" / "theta_s1.txt").exists()
    with open(tmp_path / "verify_parity.json") as fh:
        loaded = json.load(fh)
    assert loaded["loader_fingerprint"]["modes"]["trigenic/abs"]["rows"] > 0
    assert loaded["reference_mount"]["present"] is False


def test_artifact_dataset_and_layout_equal_reference(tmp_path):
    """The artifact's dataset block (row counts and digests of the packed
    arrays) equals the reference's on the same file and split; the
    converged block has the reference's keys, and the test scores file its
    header and rows (the fits start from different random draws)."""
    cfg = Config(train=TrainConfig(**TRAIN), split=SplitConfig(test_fraction=0.25, seed=0))
    jcfg = JConfig(train=JTrain(**TRAIN), split=JSplit(test_fraction=0.25, seed=0))
    art = parity_artifact(EXAMPLE, cfg, str(tmp_path / "t"), device="cpu")
    want = jparity.parity_artifact(EXAMPLE, jcfg, str(tmp_path / "j"))
    assert art["dataset"] == want["dataset"]
    assert art["config"] == want["config"]
    assert art["converged"].keys() == want["converged"].keys()
    assert [h["genes"] for h in art["predictions_head"]] == [
        h["genes"] for h in want["predictions_head"]]
    t_rows = np.loadtxt(tmp_path / "t" / "test_scores.tsv", skiprows=1)
    j_rows = np.loadtxt(tmp_path / "j" / "test_scores.tsv", skiprows=1)
    np.testing.assert_array_equal(t_rows[:, :4], j_rows[:, :4])
    with open(tmp_path / "t" / "test_scores.tsv") as fh, \
            open(tmp_path / "j" / "test_scores.tsv") as jfh:
        assert fh.readline() == jfh.readline()


@pytest.mark.parametrize("no_fit", [True, False])
def test_cli_verify_parity(tmp_path, capsys, no_fit):
    from trigenicinteractionpredictor_tpu_torch.cli import main

    out = str(tmp_path / "vp")
    args = ["verify-parity", "-f", EXAMPLE, "-k", "3", "-i", "10", "-s", "2", "-n", "5",
            "-o", out, "--device", "cpu", "--reference-mount", str(tmp_path / "absent")]
    assert main(args + (["--no-fit"] if no_fit else [])) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(out, "verify_parity.json")) as fh:
        report = json.load(fh)
    assert summary["reference_files"] == 0
    assert summary["trigenic/abs"] == report["loader_fingerprint"]["modes"]["trigenic/abs"]["rows"]
    assert ("artifact" in report) == (not no_fit) == ("heldout_auc" in summary)
    assert report["reference_mount"]["path"] == str(tmp_path / "absent")
    if not no_fit:
        assert report["artifact"]["converged"]["sweeps_run"] == 10
        assert 0.0 <= summary["heldout_auc"] <= 1.0
