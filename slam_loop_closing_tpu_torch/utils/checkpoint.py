"""Map-state checkpoints: the SfM ``MapState`` saved and restored between
pipeline stages, in the NPZ layout of
:mod:`slam_loop_closing_tpu.utils.checkpoint` (the JAX package's field names
and dtypes), so that a checkpoint written by either package loads in the
other. The port keeps descriptors packed; the file holds the JAX package's
``signed`` int8 field (+-1, invalid rows zero)."""

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
        if k == "packed":
            k = "signed"
            v = torch.where(state.kp_valid[..., None], desc_ops.bits_to_signed(
                desc_ops.packed_to_bits(v)), 0).to(torch.int8)
        fields[k] = v.cpu().numpy()
    np.savez_compressed(str(p), **fields)
    return p


def load_map_state(path: str | Path, device):
    """Restore a ``MapState`` written by :func:`save_map_state` or by the
    JAX package, on ``device``."""
    from slam_loop_closing_tpu_torch.models.sfm import MapState

    with np.load(str(path)) as z:
        fields = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    fields["packed"] = desc_ops.signed_to_packed(fields.pop("signed"))
    return MapState(**fields)


def stage_checkpoint_path(data_dir: str | Path, stage: str) -> Path:
    return Path(data_dir) / "checkpoints" / f"map_{stage}.npz"
