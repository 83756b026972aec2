"""Entry ``sequence``: a whole sequence through the port's sequence-scale
composition, as BASELINE config 2 runs it: ``orb.detect_and_describe_batch``
a batch of frames at a time, then every frame pair's good-match counts
(``matching.dense_pair_counts_chunked``, kernel I over pair lists, or
``matching.banded_pair_counts_chunked``, kernel C over frame tiles), then
``matching.similarity`` and the loop rule
(``models.loop_closing.loops_from_video_scores``). The call ends when the
loop list is on the host."""

from __future__ import annotations

import torch

from loopbench.answer import Answer, orb_work, pipeline_config

work = orb_work   # a traced call's shapes, for the yardstick


class Entry:
    def __init__(self, config: dict, args: dict, device):
        from slam_loop_closing_tpu_torch.models import loop_closing
        from slam_loop_closing_tpu_torch.ops import image, matching, orb

        self.orb, self.matching, self.image = orb, matching, image
        self.loops_from_scores = loop_closing.loops_from_video_scores
        self.cfg = pipeline_config(config)
        self.args = args
        self.device = torch.device(device)
        self.pattern = orb.brief_matrices(self.cfg.orb, self.device)

    def __call__(self, frames: torch.Tensor) -> Answer:
        cfg, args, m = self.cfg, self.args, self.matching
        signed, valid, xy, packed = [], [], [], []
        for s in range(0, frames.shape[0], args["batch"]):
            feats = self.orb.detect_and_describe_batch(
                self.image.ship_frames(frames[s:s + args["batch"]],
                                       self.device), cfg.orb, self.pattern)
            signed.append(feats.signed)
            valid.append(feats.keypoints.valid)
            xy.append(feats.keypoints.xy)
            packed.append(feats.descriptors)
        signed = torch.cat(signed)
        valid = torch.cat(valid)
        nfeat = torch.sum(valid, dim=1, dtype=torch.int32)
        scale = cfg.match.hamming_filter_scale
        if args["counts"] == "dense":
            counts = m.dense_pair_counts_chunked(
                signed, valid, scale, min_gap=args["min_gap"],
                pairs_per_call=args["pairs_per_call"])
        else:
            counts = m.banded_pair_counts_chunked(
                signed, valid, cfg.loop.min_loop_gap, scale,
                block=args["block"])
        nfeat = nfeat.cpu()
        sims = m.similarity(torch.from_numpy(counts), nfeat[:, None],
                            nfeat[None, :]).numpy()
        loops = self.loops_from_scores(counts[None], sims[None], cfg)[0]
        answer = Answer(frames=frames.shape[0], counts=counts, loops=[
            (c.current_frame_id, c.matched_frame_id, c.num_matches,
             c.similarity_score) for c in loops])
        answer.features = lambda: (torch.cat(xy), valid, torch.cat(packed))
        return answer
