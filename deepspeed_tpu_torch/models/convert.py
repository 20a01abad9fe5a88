"""HF checkpoint detection (counterpart of the part of
``deepspeed_tpu/models/convert.py`` the loaders ask first).

Importing HF weights (``load_hf_checkpoint`` and the per-family converters)
is ROADMAP queue 1 item 16. ``is_hf_checkpoint`` tells such a directory
from the port's universal checkpoints (``runtime/checkpointing.py``), so
that a loader can refuse it by name.
"""

from __future__ import annotations

import os


def is_hf_checkpoint(path: str) -> bool:
    """True if ``path`` looks like an HF checkpoint directory (weights in
    ``*.safetensors`` or ``pytorch_model*.bin`` beside a ``config.json``)."""
    if not os.path.isdir(path):
        return False
    entries = os.listdir(path)
    has_weights = any(e.endswith(".safetensors") or
                      (e.startswith("pytorch_model") and e.endswith(".bin"))
                      for e in entries)
    return has_weights and "config.json" in entries
