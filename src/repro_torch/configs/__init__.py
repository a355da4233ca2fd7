from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    get_config,
    list_configs,
    register,
)

# Import arch modules for registration side effects.
from repro_torch.configs import (  # noqa: F401
    gemma_2b,
    deepseek_7b,
    rwkv6_1_6b,
    h2o_danube_1_8b,
    recurrentgemma_9b,
    minicpm3_4b,
    granite_moe_1b_a400m,
    deepseek_v2_236b,
    whisper_medium,
    qwen2_vl_72b,
)
