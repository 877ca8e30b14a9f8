from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa
                                                 CheckpointCorruptError,
                                                 CheckpointError,
                                                 CheckpointWriteError,
                                                 latest_step,
                                                 latest_valid_step, restore,
                                                 save, validate_checkpoint)
from repro_torch.checkpoint.wal import WriteAheadLog  # noqa
