"""User-facing pipelines: the batched Version-A ``LoopClosingSystem``."""

from slam_loop_closing_tpu_torch.models.loop_closing import (  # noqa: F401
    LoopCandidate, LoopClosingSystem)
