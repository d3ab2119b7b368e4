"""Command-line entry points (counterpart of ``mipnerf360_tpu/apps``)."""
