"""Held-out evaluation (counterpart of the reference's ``eval.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops.em import log_likelihood, make_batch
from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc, average_precision
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    ensemble_predict_interaction,
    predict_interaction,
)


@dataclass
class EvalReport:
    auc: float
    average_precision: float
    best_sample_auc: float
    heldout_loglik: float         # test-set log-likelihood of the best sample
    heldout_loglik_mean: float    # mean over the restart ensemble
    n_test: int
    n_pos: int

    def to_dict(self) -> dict:
        return {
            "auc": self.auc,
            "average_precision": self.average_precision,
            "best_sample_auc": self.best_sample_auc,
            "heldout_loglik": self.heldout_loglik,
            "heldout_loglik_mean": self.heldout_loglik_mean,
            "n_test": self.n_test,
            "n_pos": self.n_pos,
        }


def evaluate(
    states: ModelState,
    test_ds: TripletDataset,
    final_loglik: Optional[np.ndarray] = None,
    interact_rating: int = 1,
) -> EvalReport:
    """Score a restart-stacked ensemble on a held-out split, on the states'
    device.

    - ensemble score: mean P(interact) over restarts;
    - best-sample score: the restart with the highest final training
      likelihood (``final_loglik``), else the highest held-out likelihood.
    """
    batch = make_batch(test_ds.triplets, test_ds.ratings, test_ds.weights, states.device)
    # Binary labels: rating == the interaction class.
    labels = batch.ratings == interact_rating

    ens_scores = ensemble_predict_interaction(states, batch.triplets, interact_rating)
    ens_auc = float(auc(ens_scores, labels, batch.weights))
    ens_ap = float(average_precision(ens_scores, labels, batch.weights))

    # Held-out log-likelihood per restart, on the raw rating classes.
    heldout_ll = (
        log_likelihood(states, batch, row_chunk=16384).cpu().numpy().astype(np.float64)
    )
    if final_loglik is not None:
        best = int(np.argmax(final_loglik))
    else:
        best = int(np.argmax(heldout_ll))
    best_state = ModelState(theta=states.theta[best], p=states.p[best])
    best_scores = predict_interaction(best_state, batch.triplets, interact_rating)
    best_auc = float(auc(best_scores, labels, batch.weights))

    real = np.asarray(test_ds.weights) > 0
    return EvalReport(
        auc=ens_auc,
        average_precision=ens_ap,
        best_sample_auc=best_auc,
        heldout_loglik=float(heldout_ll[best]),
        heldout_loglik_mean=float(heldout_ll.mean()),
        n_test=int(real.sum()),
        n_pos=int((np.asarray(test_ds.ratings)[real] == interact_rating).sum()),
    )
