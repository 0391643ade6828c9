"""Architecture configs the port serves (copies of ``repro/configs``).

Importing this package registers each architecture with
``repro_torch.config._REGISTRY``.
"""
from repro_torch.configs import (gemma_2b, granite_3_2b,  # noqa: F401
                                 rwkv6_1_6b)
