from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa
                                     adamw_update)
from repro_torch.optim.schedule import warmup_cosine  # noqa
