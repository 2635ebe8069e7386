"""Host utilities: logging and per-stage timers."""
from palace_tpu_torch.utils.logging import get_logger, log
from palace_tpu_torch.utils.timers import Metrics, StageTimer
