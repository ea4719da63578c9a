"""The training stack of the port (the reference's `repro.train`):

  * `optimizer`   — `AdamW`, `cosine_schedule`, `global_norm`,
                    `clip_by_global_norm`;
  * `checkpoint`  — `save_checkpoint`, `load_checkpoint`, `latest_step`,
                    `CheckpointManager` (the reference's on-disk format);
  * `compression` — int8 gradient quantization with error feedback;
  * `trainer`     — `lm_token_stream` and `TrainLoop` (bundle + data +
                    `runtime.ft.Supervisor`); import it as
                    `repro_torch.train.trainer`, since the supervisor
                    imports this package's checkpoint module.
"""
from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)
from .compression import dequantize_int8, ef_compress_update, quantize_int8
from .optimizer import AdamW, clip_by_global_norm, cosine_schedule, global_norm

__all__ = ["AdamW", "cosine_schedule", "global_norm", "clip_by_global_norm",
           "save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager", "quantize_int8", "dequantize_int8",
           "ef_compress_update"]
