from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger, get_logger  # noqa: F401
