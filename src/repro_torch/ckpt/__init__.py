"""repro_torch.ckpt — atomic, compressed checkpoints in the reference's
on-disk format.

  checkpoint.py  the on-disk format: atomic rename barrier, crc32 a leaf,
                 structure check, codecs a leaf, retention
  codec.py       the int8 error-feedback leaf codec (payload + scale +
                 residual, bitwise-exact restore)
  manager.py     ``CheckpointManager``: bounded async writer queue,
                 compute-overlap accounting, compressed optimizer state,
                 obs instrumentation
"""
from repro_torch.ckpt import checkpoint, codec  # noqa: F401
from repro_torch.ckpt.checkpoint import (CheckpointCorruption,  # noqa: F401
                                         TreedefMismatch, all_steps,
                                         clean_torn, latest_step,
                                         read_manifest, restore, save)
from repro_torch.ckpt.manager import (CheckpointManager,  # noqa: F401
                                      CheckpointWriteError, SaveRecord,
                                      default_compress_filter)
