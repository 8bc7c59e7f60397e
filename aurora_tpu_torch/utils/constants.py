"""Framework-wide constants (same values as aurora_tpu/utils/constants.py)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
