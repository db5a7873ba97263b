"""Top-level logger namespace, the port's counterpart of
``pointcloudmatters_tpu/loggers.py``: the path ``configs/logger/*.yaml``
targets."""

from pointcloudmatters_tpu_torch.utils.loggers import (  # noqa: F401
    AimLogger,
    BaseLogger,
    CometLogger,
    CSVLogger,
    MLFlowLogger,
    MultiLogger,
    NeptuneLogger,
    OfflineBackendLogger,
    TensorBoardLogger,
    WandbLogger,
    as_multi_logger,
)
