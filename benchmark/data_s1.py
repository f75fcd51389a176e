"""Data S1 as screened (Kuzmin et al. 2018, Science 360 eaao1729): a writer
of the configuration's TSV from the seed, and a plain reader of it.

The layout is the screen's: each double-mutant query strain (``Query
strain ID``, two genes joined by ``+``) is crossed to every single-mutant
array strain (``Array strain ID``), the rows come in query order, and the
array comes in one fixed order for every query.  Digenic control strains
(a query gene beside the ho-delta control YDL227C) are crossed to the same
array, placed evenly among the trigenic queries.  Some query genes carry an
allele suffix (``yal001c-ts``), as strains do.

Ratings come from a planted trigenic MMSBM over the configuration's genes:
theta* rows ~ Dirichlet(alpha_theta), P(interaction | k, l, m) ~
Beta(beta_positive), so positives are rare.  A row's rating is written as
its tau and P-value, so that the paper's cutoffs (P < 0.05 and |tau| >
0.08) give it back: every number is written with four decimals and chosen
on the right side of its cutoff after that rounding.  A few negative rows
carry a NaN P-value, which the cutoffs read as not significant.

:func:`read_rows` is the plain reader: ``csv``, the column names and the
cutoffs, and nothing of the measured program.
"""

from __future__ import annotations

import csv
from typing import NamedTuple

import numpy as np

from benchmark import synth

ROWS = 5  # the seed's stream for the TSV (synth's streams are 0..4)
CONTROL = "YDL227C"
HEADER = ("Query strain ID", "Array strain ID", "Combined mutant type",
          "Raw genetic interaction score (epsilon)",
          "Adjusted genetic interaction score (epsilon or tau)", "P-value",
          "Query single/double mutant fitness", "Array single mutant fitness")
QUERY, ARRAY, KIND, TAU, PVAL = 0, 1, 2, 4, 5
SUFFIXES = ("-ts", "-1", "_tsq172", "-del1", "-5001")
NAN_SHARE = 1e-3  # of the negative trigenic rows, at least one


class Written(NamedTuple):
    names: np.ndarray     # str [N, 3]: each trigenic row's genes, as the screen names them
    ratings: np.ndarray   # int32 [N]: the planted ratings the cutoffs give back
    lines: int            # data lines in the file, digenic ones too


def gene_names(n: int, gen: np.random.Generator) -> list:
    """``n`` distinct systematic-style yeast names (Y, chromosome A-P, arm
    L/R, three digits, strand W/C), none of them the control."""
    space = 16 * 2 * 999 * 2
    out = []
    for i in gen.choice(space, size=n + 1, replace=False):
        i, strand = divmod(int(i), 2)
        i, number = divmod(i, 999)
        chrom, arm = divmod(i, 2)
        name = f"Y{'ABCDEFGHIJKLMNOP'[chrom]}{'LR'[arm]}{number + 1:03d}{'WC'[strand]}"
        if name != CONTROL:
            out.append(name)
    return out[:n]


def _fixed4(x: np.ndarray) -> list:
    """Integer ten-thousandths as text with four decimals."""
    return [f"{'-' if v < 0 else ''}{abs(v) // 10000}.{abs(v) % 10000:04d}" for v in x.tolist()]


def write_tsv(path: str, config: dict, seed: int) -> Written:
    """Write the configuration's screen (``n_query_pairs`` x
    ``n_array_genes`` trigenic rows, its digenic share of lines, its
    suffix share of query genes, its planted MMSBM) from ``seed``."""
    q, a, k = config["n_query_pairs"], config["n_array_genes"], config["k"]
    planted = config["planted"]
    gen = synth.rng(seed, ROWS)
    names = gene_names(2 * q + a, gen)
    query, array = names[:2 * q], names[2 * q:]
    suffix = np.where(gen.random(2 * q) < config["suffix_share"],
                      gen.integers(0, len(SUFFIXES), 2 * q), -1)
    token = [g.lower() + (SUFFIXES[s] if s >= 0 else "") for g, s in zip(query, suffix)]
    theta = gen.dirichlet(np.full(k, planted["alpha_theta"]), size=2 * q + a)
    pos = gen.beta(*planted["beta_positive"], size=(k, k, k))

    # Rows in query order: pair i's genes 2i, 2i + 1, then the array in order.
    genes = np.stack([np.repeat(np.arange(0, 2 * q, 2), a), np.repeat(np.arange(1, 2 * q, 2), a),
                      np.tile(np.arange(2 * q, 2 * q + a), q)], 1)
    cdf = np.cumsum(theta, 1)
    z = [(gen.random(q * a)[:, None] > cdf[genes[:, c], :-1]).sum(1) for c in range(3)]
    ratings = (gen.random(q * a) < pos[z[0], z[1], z[2]]).astype(np.int32)

    # tau and P in ten-thousandths, on the right side of the cutoffs once written.
    n = q * a
    p_cut, t_cut = round(config["p_cutoff"] * 1e4), round(config["tau_cutoff"] * 1e4)
    pval = gen.integers(0, p_cut, n)
    tau = gen.integers(t_cut + 1, 5000, n) * np.where(gen.random(n) < 0.8, -1, 1)
    neg = ratings == 0
    by_p = neg & (gen.random(n) < 0.5)      # not significant by P
    by_tau = neg & ~by_p                    # significant P, too small a tau
    pval[by_p] = gen.integers(p_cut, 10001, int(by_p.sum()))
    tau[by_p] = gen.integers(-5000, 5001, int(by_p.sum()))
    tau[by_tau] = gen.integers(-t_cut, t_cut + 1, int(by_tau.sum()))
    nan = neg & (gen.random(n) < NAN_SHARE)
    nan[np.flatnonzero(neg)[:1]] = True
    p_text = _fixed4(pval)
    for i in np.flatnonzero(nan).tolist():
        p_text[i] = "NaN"
    tau_text, raw_text = _fixed4(tau), _fixed4(tau + tau // 10)
    fit_q, fit_a = _fixed4(gen.integers(0, 10001, n)), _fixed4(gen.integers(0, 10001, n))

    n_dig = round(q * config["digenic_lines"] / (1.0 - config["digenic_lines"]))
    every = q // n_dig if n_dig else q + 1
    lines = [HEADER]
    for i in range(q):
        strain = f"{token[2 * i]}+{token[2 * i + 1]}"
        for j in range(i * a, (i + 1) * a):
            lines.append((strain, array[j - i * a].lower(), "trigenic", raw_text[j], tau_text[j],
                          p_text[j], fit_q[j], fit_a[j]))
        if (i + 1) % every == 0 and (i + 1) // every <= n_dig:
            strain = f"{token[2 * i]}+{CONTROL.lower()}"
            for j in range(i * a, (i + 1) * a):
                lines.append((strain, array[j - i * a].lower(), "digenic", raw_text[j],
                              tau_text[j], p_text[j], fit_q[j], fit_a[j]))
    with open(path, "w") as fh:
        fh.write("\n".join("\t".join(row) for row in lines) + "\n")
    return Written(np.asarray(names)[genes], ratings, len(lines) - 1)


def _gene(token: str) -> str:
    for sep in "-_":
        token = token.split(sep)[0]
    return token.strip().upper()


def read_rows(path: str, p_cutoff: float, tau_cutoff: float):
    """The plain reader: the trigenic rows' genes (str [N, 3], allele
    suffixes dropped, upper case) and labels (int32 [N]; 1 iff P <
    ``p_cutoff`` and |tau| > ``tau_cutoff``), in file order."""
    genes, labels = [], []
    with open(path, newline="") as fh:
        reader = csv.reader(fh, delimiter="\t")
        col = {name: i for i, name in enumerate(next(reader))}
        qi, ai, ki = col[HEADER[QUERY]], col[HEADER[ARRAY]], col[HEADER[KIND]]
        ti, pi = col[HEADER[TAU]], col[HEADER[PVAL]]
        for rec in reader:
            if rec[ki] != "trigenic":
                continue
            first, second = rec[qi].split("+")
            genes.append((_gene(first), _gene(second), _gene(rec[ai])))
            labels.append(int(float(rec[pi]) < p_cutoff and abs(float(rec[ti])) > tau_cutoff))
    return np.asarray(genes, dtype=str).reshape(-1, 3), np.asarray(labels, np.int32)
