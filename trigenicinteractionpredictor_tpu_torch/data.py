"""The reference's jax-free data layer, re-exported for the port.

Packing, the Kuzmin TSV loader, seeded splits and the synthetic generator
are plain NumPy in the reference package and are reused unchanged.
"""

from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv  # noqa: F401
from trigenicinteractionpredictor_tpu.data.packing import TripletDataset  # noqa: F401
from trigenicinteractionpredictor_tpu.data.splits import (  # noqa: F401
    kfold_splits,
    train_test_split,
)
from trigenicinteractionpredictor_tpu.data.synthetic import (  # noqa: F401
    sample_synthetic_dataset,
)
