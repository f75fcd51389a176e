"""Frozen experiment configuration (reference layer L6).

The reference drives everything through getopt-style CLI flags (data file,
K, #iterations, #samples, likelihood-check frequency, output dir — SURVEY.md
§2 L6 / §3.1 "CLI / arg parsing").  Here the same knobs — plus the ones the
TPU re-design adds (mesh shape, kernel backend, padding, dtypes) — live in a
single frozen dataclass that is serialized into every checkpoint and report
for reproducibility (SURVEY.md §6 "Config / flag system").

The port's own copy of the reference's ``config.py``: the same fields and
defaults, so ``Config.to_json()`` gives the same text in both packages and
either reads the other's checkpoints and reports.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Kuzmin-style loader knobs (SURVEY.md §1.3, §8.4 risk 5).

    Every label-semantics cutoff is explicit so that the chosen values are
    recorded in reports; silently diverging from the reference's dataset
    filtering is the main parity risk.
    """

    path: Optional[str] = None
    # Label binarization: interaction iff p_value < p_cutoff and the adjusted
    # (tau) score passes the magnitude test.
    p_cutoff: float = 0.05
    tau_cutoff: float = 0.08
    # 'abs'      -> |tau| > tau_cutoff counts as interaction
    # 'negative' -> tau < -tau_cutoff (Kuzmin's signal is dominated by
    #               negative interactions)
    tau_mode: str = "abs"
    # Row filter on the "Combined mutant type" column.  "trigenic" yields
    # arity-3 rows (the reference's only mode); "digenic" yields arity-2
    # pair rows for the pairwise MMSBM family.
    mutant_type: str = "trigenic"
    # Genes treated as screen controls when extracting digenic pairs: Data
    # S1's digenic query strains pair the gene of interest with the ho-delta
    # control (YDL227C), which is not part of the interaction.  A digenic
    # row must reduce to exactly 2 non-control genes or it is skipped.
    control_genes: Tuple[str, ...] = ("YDL227C",)
    # Strip allele suffixes from strain gene tokens ("ydl227c-1" -> "YDL227C").
    strip_allele_suffix: bool = True
    # Deduplicate repeated (sorted triplet) observations, keeping the first.
    deduplicate: bool = False
    # Number of rating classes (binary interaction by default).
    n_ratings: int = 2


@dataclass(frozen=True)
class TrainConfig:
    """EM loop knobs (reference: -k, -i, -s, likelihood frequency flags)."""

    k: int = 10                      # latent groups K
    sweeps: int = 400                # max EM sweeps per restart
    samples: int = 1                 # independent random restarts (ensemble)
    likelihood_freq: int = 10        # compute L every this many sweeps
    tol: float = 0.0                 # early stop when |dL| < tol (0 = never)
    seed: int = 0
    # Simplex initialization concentration (Dirichlet alpha); 1.0 = uniform.
    init_alpha: float = 1.0
    checkpoint_every: int = 0        # sweeps between checkpoints (0 = off)
    # Debug mode: raise on the first NaN produced on device (jax_debug_nans)
    # — the CI-grade sanitizer for this workload (SURVEY.md §6).
    debug_nans: bool = False
    # Stepwise (incremental/minibatch) EM: update parameters after every
    # ``minibatch`` rows instead of once per full sweep (0 = classic EM).
    # The mode for data too large for full-batch sweeps (streaming /
    # beyond-HBM); at HBM-resident scale classic EM through the Pallas
    # kernel is faster (BASELINE.md).  Per-update monotonicity is not
    # guaranteed.  ``sweeps`` counts epochs in this mode.
    minibatch: int = 0
    # Robbins-Monro decay of the running-statistics weight:
    # rho_t = (stepwise_t0 + t)^(-stepwise_kappa), kappa in (0.5, 1].
    stepwise_kappa: float = 0.6
    stepwise_t0: float = 2.0
    # Beyond-HBM streaming (stepwise mode only): dispatch each epoch as
    # groups of this many minibatches, so device memory holds one group
    # (stream_groups * minibatch rows) instead of the whole epoch.  Pair
    # with TripletDataset.load_dir(mmap=True) so the host side streams off
    # disk too.  0 = whole epoch per dispatch (fastest when data fits HBM).
    # NOTE: with stream_prefetch on (the default), the NEXT group is
    # transferred while the current one is still resident, so size
    # stream_groups for TWO groups of HBM headroom — or set
    # stream_prefetch=False for strict one-group residency (ADVICE r4).
    stream_groups: int = 0
    # One-group-lookahead prefetch: overlap the next group's host prep +
    # host->device transfer with device execution.  Costs up to 2x group
    # residency in HBM (see stream_groups); turn off for HBM-tight runs.
    stream_prefetch: bool = True
    # Host-prep process pool (train/stream_prep.py): 0 = auto (pool only
    # when there are spare cores and >= ~1M rows per group), 1 = always
    # in-thread (vectorized single-thread prep), N >= 2 = pool of N
    # spawn workers writing into shared memory.
    stream_prep_workers: int = 0
    # --- quality knobs beyond the reference's EM (all default OFF so the
    # default configuration reproduces reference parity; VERDICT round 1
    # item 1 / BASELINE.json:5 "match or beat") -------------------------
    # Deterministic annealing (DAEM): start the EM at inverse temperature
    # beta0 < 1 (responsibilities smoothed toward uniform, merging nearby
    # local-optimum basins) and ramp geometrically to beta = 1 over
    # anneal_sweeps.  1.0 = off.
    anneal_beta0: float = 1.0
    # Sweeps over which beta ramps beta0 -> 1; 0 = half of ``sweeps``.
    anneal_sweeps: int = 0
    # Perturb-and-resweep refinement: after the main fit, re-seed the whole
    # restart ensemble from Dirichlet perturbations of the best state and
    # run extra sweeps, keeping the best final likelihood.  Restart 0 keeps
    # the unperturbed best state, so (by EM monotonicity) refinement never
    # loses likelihood.  0 = off.
    refine_rounds: int = 0
    refine_sweeps: int = 0           # extra sweeps per round; 0 = sweeps/4
    refine_eps: float = 0.25         # perturbation mix toward Dirichlet noise
    # Split-merge EM rounds (models/proposals.py): after the main fit,
    # re-seed the restart ensemble with merge+split topology jumps from the
    # best state and resweep, accepting only likelihood improvements.
    # Restart 0 keeps the unperturbed best, so likelihood never drops.
    # Runs before refine_rounds (topology jumps first, local polish after).
    # 0 = off.  Measured: best train likelihood of any cold-start method
    # tested (BASELINE.md "EM quality study").
    smem_rounds: int = 0
    smem_sweeps: int = 0             # extra sweeps per round; 0 = sweeps/4
    # Initialization: 'random' (reference-style Dirichlet) or 'spectral'
    # (informed init from the pairwise co-interaction spectrum; restarts
    # differ by Dirichlet noise mixed in at increasing strength).
    init_method: str = "random"


@dataclass(frozen=True)
class SplitConfig:
    """Train/test splitting (reference: 80/20 fold and 5-fold CV)."""

    test_fraction: float = 0.2
    n_folds: int = 1                 # 1 = single 80/20 split; >1 = k-fold CV
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for the data-parallel EM sweep (SURVEY.md §3.3).

    The triplet list shards over the ``data`` axis; theta and p are
    replicated; sufficient statistics psum once per sweep.  Restarts vmap
    within a chip and may also shard over the ``ensemble`` axis.
    """

    data: int = 1                    # number of shards along the triplet axis
    ensemble: int = 1                # number of shards along the restart axis
    # Tensor parallelism over p's l axis — the large-K regime (K >~ 50,
    # where K^3 objects dominate memory).  model > 1 switches the trainer
    # to the TP step (parallel/tensor_parallel.py); the Pallas kernels are
    # bypassed there (p is sharded) in favor of the jnp path.
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.ensemble * self.model


@dataclass(frozen=True)
class EngineConfig:
    """Compute-path selection and padding."""

    backend: str = "auto"            # 'jnp' | 'pallas' | 'auto'
    # Pad the triplet batch length to a multiple of this (shard/tile friendly).
    batch_pad_multiple: int = 512
    # Pallas tile size along the triplet axis (upper bound; dispatch
    # auto-shrinks it to fit VMEM at large K/G/ensemble widths).
    tile_b: int = 512
    # Row-chunk size for the jnp/XLA path and likelihood passes (0 = off).
    # Bounds XLA fusion tiles at large K, where the per-rating gather over
    # the whole [B, K, K] tensor exceeds the 16 MB scoped-VMEM limit.
    jnp_row_chunk: int = 16384
    # Kernel numerics mode.  'fast' (default): MXU matmuls run at DEFAULT
    # precision (bf16 operand passes) — measured ~30% faster, but on-chip
    # 60-sweep likelihood traces show occasional small decreases (~3e-4
    # relative; BASELINE.md numerics note), so tol-based early stopping
    # reads a slightly noisy trace.  'strict': every kernel matmul runs at
    # HIGHEST precision — the monotone-likelihood EM invariant holds
    # on-chip (tests/test_tpu_numerics.py) at a measured throughput cost.
    # The jnp path always runs HIGHEST and is unaffected.
    precision: str = "fast"
    # Restart sub-group width for the bdr kernel's block-diagonal stages
    # (0 = measured-best rule: largest divisor of S with group*K <= 128
    # MXU lanes — ops/dispatch.py _pick_bdr_group).  Must divide the
    # per-device restart count.  tools/bdr_group_sweep.py measures the
    # frontier; the resolved choice is recorded in the fit report and
    # checkpoint for reproducibility.
    bdr_group: int = 0


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    split: SplitConfig = field(default_factory=SplitConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    out_dir: str = "runs/default"

    # ------------------------------------------------------------------
    # (De)serialization — configs ride along in checkpoints and reports.
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**d.get("train", {})),
            split=SplitConfig(**d.get("split", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
            engine=EngineConfig(**d.get("engine", {})),
            out_dir=d.get("out_dir", "runs/default"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
