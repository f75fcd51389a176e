"""The port's native Kuzmin tokenizer (``native/``) against the port's
Python parser and the reference's parser, on the CPU: the same rows on
every ``DataConfig`` case, the loader's native path, and failures that
raise instead of falling back.  Ports the four tests of the reference's
tests/test_native_parser.py; rows compare exactly."""

import os

import numpy as np
import pytest

from trigenicinteractionpredictor_tpu.config import DataConfig as JDataConfig
from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv as jload
from trigenicinteractionpredictor_tpu.data.kuzmin import parse_kuzmin_rows as jparse_rows
from trigenicinteractionpredictor_tpu_torch.config import DataConfig
from trigenicinteractionpredictor_tpu_torch.data import kuzmin, write_kuzmin_like_tsv
from trigenicinteractionpredictor_tpu_torch.native import binding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "datasets", "example_trigenic.tsv")
CASES = {
    "default": {},
    "negative": {"tau_mode": "negative"},
    "tight": {"p_cutoff": 0.01, "tau_cutoff": 0.2},
    "no-strip": {"strip_allele_suffix": False},
    "dedup": {"deduplicate": True},
}


def _python_rows(path, cfg):
    with open(path, newline="") as fh:
        return kuzmin.parse_kuzmin_rows(fh, cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_python(tmp_path, case):
    """Native rows equal the port's Python parser's and the reference's."""
    path = str(tmp_path / "k.tsv")
    write_kuzmin_like_tsv(path, n_rows=500, n_genes=40, seed=2)
    cfg = DataConfig(**CASES[case])
    nat = binding.parse_kuzmin_file(path, cfg)
    assert nat == _python_rows(path, cfg)
    with open(path, newline="") as fh:
        assert nat == jparse_rows(fh, JDataConfig(**CASES[case]))
    assert len(nat) > 0


def test_native_missing_columns(tmp_path):
    path = str(tmp_path / "bad.tsv")
    with open(path, "w") as fh:
        fh.write("foo\tbar\n1\t2\n")
    with pytest.raises(ValueError, match="missing required columns"):
        binding.parse_kuzmin_file(path, DataConfig())
    with pytest.raises(FileNotFoundError):
        binding.parse_kuzmin_file(str(tmp_path / "absent.tsv"), DataConfig())


def test_native_empty_file(tmp_path):
    path = str(tmp_path / "empty.tsv")
    open(path, "w").close()
    assert binding.parse_kuzmin_file(path, DataConfig()) == []
    assert _python_rows(path, DataConfig()) == []


def test_loader_takes_the_native_path(tmp_path):
    """load_kuzmin_tsv parses a trigenic file natively (the counter moves)
    into the arrays the Python parser gives; a digenic file stays on the
    Python parser (the counter stays), as in the reference."""
    path = str(tmp_path / "k.tsv")
    write_kuzmin_like_tsv(path, n_rows=300, n_genes=30, seed=5)
    before = binding.parses
    ds = kuzmin.load_kuzmin_tsv(path)
    assert binding.parses == before + 1
    py = _python_rows(path, DataConfig())
    assert ds.n_rows == len(py)
    np.testing.assert_array_equal(ds.ratings, np.array([r for *_, r in py], dtype=np.int32))
    di = kuzmin.load_kuzmin_tsv(path, DataConfig(mutant_type="digenic"))
    assert binding.parses == before + 1 and di.arity == 2


def test_example_tsv_gives_the_reference_arrays():
    """The bundled example through the port's native loader and through the
    reference's loader: the same packed arrays and gene names."""
    before = binding.parses
    ds = kuzmin.load_kuzmin_tsv(EXAMPLE)
    want = jload(EXAMPLE)
    assert binding.parses == before + 1
    assert (ds.n_genes, ds.n_ratings, ds.gene_names) == (want.n_genes, want.n_ratings,
                                                         want.gene_names)
    for name in ("triplets", "ratings", "weights"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(want, name))
    assert _python_rows(EXAMPLE, DataConfig()) == binding.parse_kuzmin_file(EXAMPLE,
                                                                             DataConfig())


def test_a_broken_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message;
    the loader does not fall back to the Python parser."""
    broken = tmp_path / "kuzmin_parser.cpp"
    broken.write_text(binding.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(binding, "SOURCE", broken)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native Kuzmin tokenizer failed"
                       "(.|\n)*error"):
        kuzmin.load_kuzmin_tsv(EXAMPLE)
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_logs_and_uses_the_python_parser(monkeypatch, capsys):
    """Only with no C++ compiler on PATH does the loader parse in Python,
    and it says so."""
    monkeypatch.setattr(binding, "compiler", lambda: None)
    before = binding.parses
    ds = kuzmin.load_kuzmin_tsv(EXAMPLE)
    assert binding.parses == before
    assert "native_tokenizer" in capsys.readouterr().err
    np.testing.assert_array_equal(ds.triplets, jload(EXAMPLE).triplets)
