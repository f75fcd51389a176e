from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset  # noqa: F401
from trigenicinteractionpredictor_tpu_torch.data.kuzmin import load_kuzmin_tsv, parse_kuzmin_tsv  # noqa: F401
from trigenicinteractionpredictor_tpu_torch.data.splits import kfold_splits, train_test_split  # noqa: F401
from trigenicinteractionpredictor_tpu_torch.data.synthetic import (  # noqa: F401
    sample_ground_truth,
    sample_synthetic_dataset,
    write_kuzmin_like_tsv,
)
