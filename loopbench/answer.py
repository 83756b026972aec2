"""What one timed call of an entry hands back, the program's configuration
built from a configuration file, and the shapes of an ORB front-end call
that the yardstick takes."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    """One call's result as the host holds it when the call returns.

    ``loops``: the program's loop list, (query, target, count, similarity)
    in its order. ``counts``: the program's [F, F] count matrix where the
    entry has one on the host (``None`` where it keeps only the loops).
    ``features``: a callable giving (xy [F, K, 2], valid [F, K], packed
    [F, K, 8]) of the program's front-end, read after the window; the
    harness drops it from calls that are neither judged nor traced.
    """

    frames: int
    loops: list
    counts: np.ndarray | None = None
    features: object = None


def pipeline_config(config: dict):
    """The port's ``PipelineConfig`` of a configuration file (its ``orb``,
    ``match`` and ``loop`` groups; the README's assumed camera)."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig, LoopConfig,
                                                    MatchConfig, OrbConfig,
                                                    PipelineConfig)

    return dataclasses.replace(
        PipelineConfig(), camera=CameraConfig.assumed(),
        orb=OrbConfig(**config["orb"]),
        match=dataclasses.replace(MatchConfig(), **config["match"]),
        loop=dataclasses.replace(LoopConfig(), **config["loop"]))


def orb_work(answer: Answer, cell) -> dict:
    """Shapes and valid rows of a traced call of an ORB front-end and its
    counts, for the yardstick (``yardstick/work.py``)."""
    _, valid, _ = answer.features()
    return {"frames": answer.frames, "nfeat": valid.sum(1).cpu().numpy(),
            "slots": valid.shape[1],
            "gap": cell.workload["args"].get(
                "min_gap", cell.config["loop"]["min_loop_gap"]),
            "height": cell.traffic["height"], "width": cell.traffic["width"]}
