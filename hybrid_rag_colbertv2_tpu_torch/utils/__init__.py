from .logging import get_logger, StageTimer  # noqa: F401
from .device import resolve_device  # noqa: F401
