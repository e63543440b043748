from repro_torch.checkpoint.manager import (CheckpointManager, params_digest,
                                            restore_latest)

__all__ = ["CheckpointManager", "params_digest", "restore_latest"]
