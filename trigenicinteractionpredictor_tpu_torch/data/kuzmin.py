"""Kuzmin et al. 2018 (Science, aao1729) Data S1 TSV parser (layer L1).

Reconstructed loader semantics (SURVEY.md §1.3, §4.3): the supplementary
Data S1 file is a TSV of double-mutant-query x single-mutant-array screens.
Relevant columns: ``Query strain ID`` (two genes joined by '+', possibly with
allele suffixes), ``Array strain ID`` (third gene), ``Combined mutant type``
('digenic' / 'trigenic'), the adjusted interaction score (tau), and
``P-value``.  The loader filters to trigenic rows, extracts the three
systematic gene names, and binarizes the label with the paper's significance
criteria (interaction iff P < 0.05 and the tau magnitude test passes).

Every cutoff is a :class:`~trigenicinteractionpredictor_tpu_torch.config.DataConfig`
knob, and id assignment is by sorted gene name so folds reproduce across
hosts (SURVEY.md §8.4 risks 5 and 7).

The port's copy of the reference's ``data/kuzmin.py``.  Trigenic files go
through the port's native C++ tokenizer (``native/``, the same semantics,
built at first use); this module is the semantic source of truth and
parses digenic files, and trigenic ones only where no g++ is on
``PATH``.
"""

from __future__ import annotations

import csv
import io
import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.config import DataConfig
from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.utils.logging import get_logger
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span

# Column-name aliases, matched case-insensitively after whitespace squeeze.
_QUERY_COLS = ("query strain id", "query strain", "query")
_ARRAY_COLS = ("array strain id", "array strain", "array")
_TYPE_COLS = ("combined mutant type", "mutant type")
_TAU_COLS = (
    "adjusted genetic interaction score (epsilon or tau)",
    "adjusted genetic interaction score",
    "tau",
)
_RAW_COLS = (
    "raw genetic interaction score (epsilon)",
    "raw genetic interaction score",
    "epsilon",
)
_PVAL_COLS = ("p-value", "pvalue", "p value")

_ALLELE_RE = re.compile(r"[-_].*$")


def _norm_col(name: str) -> str:
    return " ".join(name.strip().lower().split())


def _find_col(header: Sequence[str], aliases: Sequence[str]) -> Optional[int]:
    normed = [_norm_col(h) for h in header]
    for alias in aliases:
        if alias in normed:
            return normed.index(alias)
    # Prefix match as a fallback (column names drift between releases).
    for alias in aliases:
        for i, h in enumerate(normed):
            if h.startswith(alias):
                return i
    return None


def normalize_gene(token: str, strip_allele_suffix: bool = True) -> str:
    """'ydl227c-1' -> 'YDL227C': upper-case and drop the allele suffix."""
    token = token.strip()
    if strip_allele_suffix:
        token = _ALLELE_RE.sub("", token)
    return token.upper()


def split_query_strain(
    query: str, strip_allele_suffix: bool = True
) -> Optional[Tuple[str, str]]:
    """Split a 'geneA+geneB' query strain id into two normalized genes."""
    parts = query.split("+")
    if len(parts) != 2:
        return None
    a = normalize_gene(parts[0], strip_allele_suffix)
    b = normalize_gene(parts[1], strip_allele_suffix)
    if not a or not b:
        return None
    return a, b


def binarize_label(tau: float, p_value: float, cfg: DataConfig) -> int:
    """1 iff the row is a significant interaction under the paper's criteria.

    Written require-significance-positively (``p < cutoff``, not
    ``p >= cutoff -> 0``) so a NaN p-value fails the test and labels 0 —
    matching the native C++ parser's comparison direction.
    """
    if not (p_value < cfg.p_cutoff):
        return 0
    if cfg.tau_mode == "negative":
        return int(tau < -cfg.tau_cutoff)
    return int(abs(tau) > cfg.tau_cutoff)


def parse_kuzmin_rows(
    lines: Iterable[str], cfg: DataConfig
) -> List[Tuple]:
    """Parse TSV text into (gene, ..., gene, rating) rows.

    ``cfg.mutant_type == "trigenic"`` (the reference's mode) yields 3-gene
    rows.  ``"digenic"`` yields 2-gene rows: the row's genes (two query
    slots + array slot) are reduced by dropping ``cfg.control_genes`` (the
    ho-delta screen control rides in one query slot of digenic strains) and
    the row is kept only if exactly two distinct genes remain.
    """
    reader = csv.reader(lines, delimiter="\t")
    try:
        header = next(reader)
    except StopIteration:
        return []
    qi = _find_col(header, _QUERY_COLS)
    ai = _find_col(header, _ARRAY_COLS)
    ti = _find_col(header, _TYPE_COLS)
    taui = _find_col(header, _TAU_COLS)
    if taui is None:
        taui = _find_col(header, _RAW_COLS)
    pi = _find_col(header, _PVAL_COLS)
    if qi is None or ai is None or taui is None or pi is None:
        raise ValueError(
            f"Kuzmin TSV is missing required columns; header was: {header!r}"
        )

    digenic = cfg.mutant_type == "digenic"
    controls = {
        normalize_gene(g, cfg.strip_allele_suffix)
        for g in getattr(cfg, "control_genes", ()) or ()
    }
    rows: List[Tuple] = []
    seen = set()
    needed = max(qi, ai, taui, pi, ti if ti is not None else 0)
    for rec in reader:
        if len(rec) <= needed:
            continue
        if ti is not None and cfg.mutant_type:
            if _norm_col(rec[ti]) != cfg.mutant_type:
                continue
        pair = split_query_strain(rec[qi], cfg.strip_allele_suffix)
        if pair is None:
            continue
        c = normalize_gene(rec[ai], cfg.strip_allele_suffix)
        if not c:
            continue
        try:
            tau = float(rec[taui])
            p_value = float(rec[pi])
        except ValueError:
            continue
        a, b = pair
        if digenic:
            genes = [g for g in dict.fromkeys((a, b, c)) if g not in controls]
            if len(genes) != 2:
                continue
        else:
            genes = [a, b, c]
        if cfg.deduplicate:
            key = tuple(sorted(genes))
            if key in seen:
                continue
            seen.add(key)
        rows.append((*genes, binarize_label(tau, p_value, cfg)))
    return rows


def _arity(cfg: DataConfig) -> int:
    return 2 if cfg.mutant_type == "digenic" else 3


def parse_kuzmin_tsv(text: str, cfg: Optional[DataConfig] = None) -> TripletDataset:
    cfg = cfg or DataConfig()
    rows = parse_kuzmin_rows(io.StringIO(text), cfg)
    return TripletDataset.from_rows(rows, n_ratings=cfg.n_ratings, arity=_arity(cfg))


def load_kuzmin_tsv(path: str, cfg: Optional[DataConfig] = None) -> TripletDataset:
    """Load and pack a Kuzmin-style TSV.

    Trigenic rows come from the native tokenizer (``native/binding.py``);
    its build or parse errors raise.  Digenic rows (pair extraction lives
    here) and hosts with no g++ on ``PATH`` (logged) take the
    pure-Python parser.  Spans: ``data.parse`` (the file to name rows),
    ``data.pack`` (name rows to the packed arrays).
    """
    from trigenicinteractionpredictor_tpu_torch.native import binding

    cfg = cfg or DataConfig()
    with span("data.parse"):
        if _arity(cfg) == 3 and binding.compiler() is not None:
            rows = binding.parse_kuzmin_file(path, cfg)
        else:
            if _arity(cfg) == 3:
                get_logger().log("native_tokenizer", available=False,
                                 reason="no g++ on PATH; using the Python parser")
            with open(path, "r", newline="") as fh:
                rows = parse_kuzmin_rows(fh, cfg)
    with span("data.pack"):
        return TripletDataset.from_rows(rows, n_ratings=cfg.n_ratings, arity=_arity(cfg))
