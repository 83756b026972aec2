"""Map-state checkpoints: the SfM ``MapState`` saved and restored between
pipeline stages, in the NPZ layout of
:mod:`slam_loop_closing_tpu.utils.checkpoint` (the JAX package's field names
and dtypes), so that a checkpoint written by either package loads in the
other. The file's ``signed`` field is the JAX package's: int8 +-1 rows
(invalid rows zero) for ORB, which the port keeps packed into int32 words,
and float32 [K, N, 128] rows for SIFT, which the port keeps as they are."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops


def save_map_state(path: str | Path, state) -> Path:
    """Write a port ``MapState`` as compressed NPZ."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fields = {}
    for k, v in state._asdict().items():
        if k == "desc":
            k = "signed"
            if not v.dtype.is_floating_point:    # ORB words -> int8 +-1
                v = torch.where(state.kp_valid[..., None],
                                desc_ops.bits_to_signed(
                                    desc_ops.packed_to_bits(v)),
                                0).to(torch.int8)
        fields[k] = v.cpu().numpy()
    np.savez_compressed(str(p), **fields)
    return p


def load_map_state(path: str | Path, device):
    """Restore a ``MapState`` written by :func:`save_map_state` or by the
    JAX package, on ``device``."""
    from slam_loop_closing_tpu_torch.models.sfm import MapState

    with np.load(str(path)) as z:
        fields = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    fields["desc"] = desc_from_signed(fields.pop("signed"))
    return MapState(**fields)


def desc_from_signed(signed: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``signed`` descriptor field as the port's ``desc``
    store: int8 +-1 rows (ORB) packed into [..., 8] int32 words, float32
    [..., 128] rows (SIFT) as they are."""
    if signed.dtype.is_floating_point:
        return signed
    return desc_ops.signed_to_packed(signed)


def stage_checkpoint_path(data_dir: str | Path, stage: str) -> Path:
    return Path(data_dir) / "checkpoints" / f"map_{stage}.npz"
