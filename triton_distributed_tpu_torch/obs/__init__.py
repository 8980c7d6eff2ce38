"""Cost model of the kernels (counterpart of ``triton_distributed_tpu/obs``;
the counters, spans and flight recorder come with a later slice)."""
