"""The comparison that decides ``correct`` for Version-A loop detection, its
control, and the run's loop-rule pass share.

The judged calls of a run are drawn from the seed before the window opens.
For each, once the window has closed and the program's state is freed, the
plain reference (``reference/orb.py``, ``reference/loops.py``) works the
answer out again from the same frames, and three numbers are counted
against the program's whole answer. Each is exact, with limit 0:

* ``frontend_differ``: keypoint slots of the call's frames whose position,
  validity or (valid slots) descriptor words differ;
* ``counts_differ``: frame pairs whose good-match count differs, over every
  count the program's answer holds (its count matrix, or the counts of its
  loop list);
* ``loops_differ``: frame pairs of the loop band on which the loop lists
  disagree: a loop in one and not the other, or in both with another
  similarity.

The control (:class:`Control`) is the reference put in the program's place
one precision below the configuration's: the configurations state float32
image arithmetic, and the control runs the reference's front-end in
bfloat16 (the frames, pyramid levels, FAST margins, blur, patches and
moments). Its counts and loop rule are the reference's, exact in any
precision. ``correct`` has to come out false on it.
"""

from __future__ import annotations

import numpy as np
import torch

from loopbench.answer import Answer
from loopbench.reference import loops as ref_loops
from loopbench.reference import orb as ref_orb

LIMITS = {"frontend_differ": 0, "counts_differ": 0, "loops_differ": 0}
BATCH = 8   # frames a reference front-end call


def _domain(cell) -> int:
    """The pairs ``j <= i - domain`` whose counts the cell needs."""
    return cell.workload["args"].get("min_gap",
                                     cell.config["loop"]["min_loop_gap"])


def reference_answer(frames_u8: torch.Tensor, config: dict, domain: int,
                     dt=torch.float32):
    """(xy, valid, packed, counts [F, F] of every pair ``j <= i - domain``,
    similarities [F, F], loop mask [F, F]) of a frame stack, its front-end
    ``BATCH`` frames at a time on the stack's device."""
    out = [ref_orb.front_end(frames_u8[s:s + BATCH], config["orb"], dt)
           for s in range(0, frames_u8.shape[0], BATCH)]
    xy, valid, packed = (torch.cat(p) for p in zip(*out))
    counts = ref_loops.band_counts(packed, valid, domain,
                                   config["match"]["hamming_filter_scale"])
    sims = ref_loops.similarity(counts, valid.sum(1).cpu().numpy())
    return xy, valid, packed, counts, sims, ref_loops.loop_mask(
        counts, sims, config["loop"])


def judge(answer, frames_u8: torch.Tensor, cell) -> dict:
    """The numbers of one judged call, each summed over the run and held to
    its limit in ``LIMITS``, and what was judged; ``frames_u8`` is its frame
    stack on the device the reference runs on."""
    domain = _domain(cell)
    rxy, rvalid, rpacked, counts, sims, loops = reference_answer(
        frames_u8, cell.config, domain)
    xy, valid, packed = (t.to(frames_u8.device) for t in answer.features())
    slot_differs = ((xy != rxy).any(-1) | (valid != rvalid)
                    | (rvalid & (packed != rpacked).any(-1)))
    f = answer.frames
    got = np.zeros((f, f), bool)
    got_sims = np.zeros((f, f), np.float32)
    got_counts = np.zeros((f, f), np.int64)
    for i, j, c, s in answer.loops:
        got[i, j] = True
        got_sims[i, j] = s
        got_counts[i, j] = c
    if answer.counts is not None:
        domain_mask = np.tril(np.ones((f, f), bool), -domain)
        counts_differ = int(np.sum(domain_mask & (answer.counts != counts)))
    else:
        counts_differ = int(np.sum(got & (got_counts != counts)))
    loops_differ = int(np.sum(got != loops)
                       + np.sum(got & loops & (got_sims != sims)))
    return {"frontend_differ": int(slot_differs.sum()),
            "counts_differ": counts_differ, "loops_differ": loops_differ,
            "judged_frames": f,
            "judged_pairs": max(0, f - domain) * (f - domain + 1) // 2}


def summary(answers: list, cell) -> dict:
    """The loop-rule pass share of the window's calls: loops found over the
    frame pairs of the loop band."""
    gap = cell.config["loop"]["min_loop_gap"]
    loops = sum(len(a.loops) for a in answers)
    band = sum(max(0, a.frames - gap) * (a.frames - gap + 1) // 2
               for a in answers)
    return {"loops": loops, "band_pairs": band,
            "share": loops / band if band else None}


class Control:
    """An entry of the same interface as ``entries/*.py`` that answers with
    the reference in bfloat16, in the form of the program's answer ``like``
    (its count matrix on the host, or only its loop list)."""

    def __init__(self, cell, device, like: Answer):
        self.cell = cell
        self.counts_on_host = like.counts is not None
        self.device = torch.device(device)

    def __call__(self, frames: torch.Tensor) -> Answer:
        xy, valid, packed, counts, sims, loops = reference_answer(
            frames.to(self.device), self.cell.config, _domain(self.cell),
            torch.bfloat16)
        answer = Answer(frames=frames.shape[0], loops=[
            (int(i), int(j), int(counts[i, j]), float(sims[i, j]))
            for i, j in np.argwhere(loops)],
            counts=counts if self.counts_on_host else None)
        answer.features = lambda: (xy, valid, packed)
        return answer
