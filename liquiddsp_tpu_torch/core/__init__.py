from liquiddsp_tpu_torch.core.config import (  # noqa: F401
    NUM_CONFIGS,
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
    ConfigurationMap,
    FrameConfig,
    InnerCode,
    Modulation,
    OuterCode,
    config_from_id,
    config_id,
)
