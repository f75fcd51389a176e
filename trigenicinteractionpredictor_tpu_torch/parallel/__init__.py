"""Multi-rank execution over ``torch.distributed`` (counterpart of the
reference's ``parallel/`` package): the (ensemble, model, data) mesh of
ranks, the process bootstrap, the data- and ensemble-parallel EM sweep and
the tensor-parallel sweep over p's ``l`` axis."""
