"""State carried across from the JAX package: its arrays, as numpy (or any
object ``numpy.asarray`` accepts), become the port's tensors. Used to feed
one package's intermediate results into the other's next stage, e.g. the
JAX front-end's features into the port's matcher."""

from __future__ import annotations

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import orb


def brief_matrices(d, device) -> torch.Tensor:
    """The BRIEF difference stack (``orb.brief_matrices(cfg)``,
    [bins, P*P, 256] float32)."""
    return torch.tensor(np.asarray(d, np.float32), device=device)


def moment_weights(w, device) -> torch.Tensor:
    """The orientation moment weights ([P*P, 2] float32)."""
    return torch.tensor(np.asarray(w, np.float32), device=device)


def orb_features(feats, device) -> orb.OrbFeatures:
    """An ``OrbFeatures`` of the JAX package (batched [B, K, ...] or one
    frame's [K, ...]) as the port's: keypoints, packed descriptors (uint32
    words reinterpreted as int32) and signed descriptors."""
    kp = feats.keypoints

    def t(a, dtype):
        return torch.tensor(np.asarray(a).astype(dtype, copy=False),
                            device=device)

    words = np.ascontiguousarray(np.asarray(feats.descriptors, np.uint32))
    return orb.OrbFeatures(
        keypoints=orb.Keypoints(
            xy=t(kp.xy, np.float32), response=t(kp.response, np.float32),
            angle=t(kp.angle, np.float32), octave=t(kp.octave, np.int32),
            valid=t(kp.valid, bool)),
        descriptors=torch.tensor(words.view(np.int32), device=device),
        signed=t(feats.signed, np.int8))
