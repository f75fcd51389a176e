"""Measurement studies of the port (counterparts of the reference's
``tools/``), each run as ``python -m
trigenicinteractionpredictor_tpu_torch.tools.<name>``:

- ``stepwise_host_cost`` -- the stepwise path's host prep per epoch, split
  by stage, against the card's own K1 rate;
- ``quality_study`` -- the quality knobs against plain EM on a peaky
  synthetic config;
- ``split_merge_study`` -- split-merge EM rounds on the same config;
- ``tensor_spectral_study`` -- seeds from the triplet tensor's structure.

Each takes ``--device`` (default ``cuda``; ``cpu`` runs it on the host).
"""
