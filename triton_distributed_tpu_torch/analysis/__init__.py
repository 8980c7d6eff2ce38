"""Static checks of kernel configurations (counterpart of
``triton_distributed_tpu/analysis``)."""
