"""Command-line tools (counterpart of daft_tpu/tools/): ``calibrate``."""
