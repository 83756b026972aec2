"""State carried across from the JAX package: its arrays, as numpy (or any
object ``numpy.asarray`` accepts), become the port's tensors. Used to feed
one package's intermediate results into the other's next stage, e.g. the
JAX front-end's features into the port's matcher, or a JAX system's frame
database into the port's loop scan. Random state does not carry across: a
``jax.random`` key has no ``torch.Generator`` counterpart."""

from __future__ import annotations

import numpy as np
import torch

from slam_loop_closing_tpu_torch.models import sfm
from slam_loop_closing_tpu_torch.models.loop_closing import FrameDatabase
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import matching, orb


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


def database(system, device) -> FrameDatabase:
    """The device frame database of a JAX ``LoopClosingSystem`` (its
    ``_db_signed``, ``_db_valid``, ``_db_xy`` and ``_db_nfeat`` arrays) as
    the port's, the signed descriptors packed into words."""
    signed = torch.tensor(np.asarray(system._db_signed, np.int8),
                          device=device)
    return FrameDatabase(
        packed=desc_ops.signed_to_packed(signed),
        valid=torch.tensor(np.asarray(system._db_valid, bool), device=device),
        xy=torch.tensor(np.asarray(system._db_xy, np.float32), device=device),
        nfeat=torch.tensor(np.asarray(system._db_nfeat, np.int32),
                           device=device))


def map_state(state, device) -> sfm.MapState:
    """The JAX package's SfM ``MapState`` (its arrays as numpy) as the
    port's, the signed descriptors packed into words."""
    fields = {k: torch.from_numpy(np.array(v)).to(device)
              for k, v in state._asdict().items() if k != "signed"}
    fields["packed"] = desc_ops.signed_to_packed(
        torch.from_numpy(np.array(state.signed, np.int8)).to(device))
    return sfm.MapState(**fields)


def matches(m, device) -> matching.Matches:
    """A JAX ``Matches`` as the port's (int32 indices and distances)."""
    return matching.Matches(
        idx=torch.tensor(np.asarray(m.idx, np.int32), device=device),
        dist=torch.tensor(np.asarray(m.dist, np.int32), device=device),
        mask=torch.tensor(np.asarray(m.mask, bool), device=device),
        count=torch.tensor(np.asarray(m.count, np.int32), device=device))
