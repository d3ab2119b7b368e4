"""Host utilities (counterpart of ``mipnerf360_tpu/utils``): image metrics,
the metrics logger, non-finite guards."""
