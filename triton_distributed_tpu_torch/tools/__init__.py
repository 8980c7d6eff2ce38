"""Performance models (counterpart of ``triton_distributed_tpu/tools``)."""
