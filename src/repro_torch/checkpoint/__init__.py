from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,  # noqa: F401
                                          save_checkpoint, wait_for_writes)
