"""The six-step pipeline: the stage engine (``stages``), the external
tools (``external``) and the driver (``driver``)."""
from palace_tpu_torch.pipeline.stages import Stage, StageRunner, StageSkipped
