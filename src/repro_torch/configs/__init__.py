"""Architecture configs the port serves (copies of ``repro/configs``).

Importing this package registers each architecture with
``repro_torch.config._REGISTRY``.
"""
from repro_torch.configs import (gemma3_4b, gemma_2b,  # noqa: F401
                                 glm4_9b, granite_3_2b, grok_1_314b,
                                 hymba_1_5b, olmoe_1b_7b, paligemma_3b,
                                 rwkv6_1_6b, whisper_small)
