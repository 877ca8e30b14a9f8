from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa
                                      SSMConfig, ShapeConfig)
