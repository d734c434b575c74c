from .checkpoint import (CheckpointManager, list_steps,  # noqa
                         restore_checkpoint, save_checkpoint)
