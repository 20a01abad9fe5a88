"""Model definitions (counterpart of ``deepspeed_tpu/models``)."""
