"""DiffStyle h-space style transfer — the port of the JAX
`pipelines/style_transfer.py`.

  1. invert the CONTENT image, keeping its latent xT;
  2. invert the STYLE image, recording its bottleneck h at every step;
  3. generate from the content latent, injecting the style's h by the
     norm-matched slerp (optionally inside the DiffStyle mask) for
     t >= max(t_edit, content_replace_step).

`StyleTransfer` builds the three engines once for a whole content × style
sweep (C + S inversions, C·S generations); `style_transfer` is the one-shot
wrapper. Images are NHWC in [-1, 1]; the h trajectory is NCHW
([S-1, B, C, h, w], `engine.make_invert_with_h`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from asyrp_official_torch.core.schedule import Schedule, uniform_seq
from asyrp_official_torch.models.delta import EditState
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.pipelines import engine

__all__ = ["StyleTransfer", "make_style_transfer", "style_transfer"]


class StyleTransfer:
    """The three engines of a style transfer, built once: the results of
    `invert_content` and `invert_style` can be kept and recombined freely."""

    def __init__(self, spec: ModelSpec, schedule: Schedule, *, n_inv_step: int = 40,
                 n_gen_step: int = 40, t_0: int = 999, t_edit: int = 400, hs_coeff: float = 0.9,
                 use_mask: bool = False, dt_lambda: float = 1.0, dt_end: int = 999,
                 content_replace_step: int = 0, compute_dtype=torch.float32):
        seq_inv = uniform_seq(n_inv_step, t_0)
        seq_gen = uniform_seq(n_gen_step, t_0)
        self._invert = engine.make_invert(spec, schedule, seq_inv, compute_dtype=compute_dtype)
        self._invert_h = engine.make_invert_with_h(spec, schedule, seq_inv,
                                                   compute_dtype=compute_dtype)
        # each generation step at or above the gate takes the style h recorded
        # nearest to it (records are keyed by the inversion step's source t)
        gate = max(t_edit, content_replace_step)
        rec_ts = np.array(seq_inv[:-1])
        times = [t for t in seq_gen if t >= gate]
        if not times:
            raise ValueError("no generation steps at/above t_edit — nothing to inject")
        self.row_idx = [int(np.argmin(np.abs(rec_ts - t))) for t in times]
        self._hs_coeff = torch.tensor([hs_coeff, 1.0], dtype=torch.float32)
        self._use_mask = use_mask
        self._run = engine.make_edit_generate(spec, schedule, seq_gen, t_edit=gate,
                                              delta_times=times, dt_lambda=dt_lambda,
                                              dt_end=dt_end, compute_dtype=compute_dtype)

    def invert_content(self, model, content: torch.Tensor) -> torch.Tensor:
        """content: [B, H, W, C] → its latent xT [B, H, W, C]."""
        return self._invert(model, content)[0]

    def invert_style(self, model, style: torch.Tensor) -> torch.Tensor:
        """style: [B, H, W, C] → the h trajectory [S-1, B, C, h, w]. Only row
        0 of the batch drives the injection: the rows are per step, shared
        by the content batch. On a row block (`parallel.spatial.sharded`)
        the trajectory is gathered whole; each rank injects its own rows
        (`models/delta.py`)."""
        h_traj = self._invert_h(model, style)[1]
        sg = spatial.active()
        return h_traj if sg is None else spatial.gather(h_traj, 3, sg)

    def generate(self, model, x_lat_content: torch.Tensor, h_traj: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The stylized images. The table has no eta noise, so the result is
        deterministic and `generator` draws nothing."""
        idx = torch.as_tensor(self.row_idx, device=h_traj.device)
        edit = EditState(mode="input", delta_rows=h_traj[idx, 0],
                         hs_coeff=self._hs_coeff.to(h_traj.device), input_style="slerp",
                         use_mask=self._use_mask)
        return self._run(model, edit, x_lat_content, generator)[0]


def make_style_transfer(spec: ModelSpec, schedule: Schedule, **kw) -> StyleTransfer:
    return StyleTransfer(spec, schedule, **kw)


def style_transfer(spec: ModelSpec, model, schedule: Schedule, content: torch.Tensor,
                   style: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                   compute_dtype=torch.float32, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call: (stylized, content latent). content [B, H, W, C], style
    [1, H, W, C] in [-1, 1]; exactly one style drives a call (`hs_coeff` is
    the slerp's keep of h: the position toward the style is 1 - hs_coeff)."""
    if style.shape[0] != 1:
        raise ValueError(f"style batch must be 1 (got {style.shape[0]}): h rows are shared per "
                         "step — call once per style image")
    st = StyleTransfer(spec, schedule, compute_dtype=compute_dtype, **kw)
    x_lat = st.invert_content(model, content)
    return st.generate(model, x_lat, st.invert_style(model, style), generator), x_lat
