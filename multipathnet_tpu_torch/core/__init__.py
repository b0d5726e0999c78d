from multipathnet_tpu_torch.core.config import (  # noqa: F401
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    TrainConfig,
    preset,
    PRESETS,
)
