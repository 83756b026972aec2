"""Entry ``video``: one frame stack through a fresh
``LoopClosingSystem(...).process_video``, as the CLI's loop mode builds one
system a run (``cli.py``'s ``cmd_loop``). The call ends when the loop list
is on the host."""

from __future__ import annotations

import torch

from loopbench.answer import Answer, orb_work, pipeline_config

work = orb_work   # a traced call's shapes, for the yardstick


def _quiet(*_args, **_kwargs):
    pass


class Entry:
    def __init__(self, config: dict, args: dict, device):
        from slam_loop_closing_tpu_torch.models.loop_closing import \
            LoopClosingSystem

        self.system_class = LoopClosingSystem
        self.cfg = pipeline_config(config)
        self.max_frames = args["max_frames"]
        self.device = torch.device(device)

    def __call__(self, frames: torch.Tensor) -> Answer:
        system = self.system_class(
            self.cfg, max_frames=max(self.max_frames, frames.shape[0]),
            log=_quiet, device=self.device)
        loops = system.process_video(frames)
        answer = Answer(frames=frames.shape[0], loops=[
            (c.current_frame_id, c.matched_frame_id, c.num_matches,
             c.similarity_score) for c in loops])
        kept = system.frames
        answer.features = lambda: (
            torch.stack([f.keypoints_xy for f in kept]),
            torch.stack([f.keypoints_valid for f in kept]),
            torch.stack([f.descriptors for f in kept]))
        return answer
