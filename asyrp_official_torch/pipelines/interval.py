"""Interval selection — the port's copy of the JAX package's
`pipelines/interval.py`: t_edit / t_addnoise from the LPIPS curves, the
edit threshold scaled by the CLIP text cosine of the source and target
prompts:

  * t_edit = first t (ascending) with LPIPS(x0_t, x0)[t] >= lpips_edit_th · cosine;
  * t_addnoise = first t with curve[t] >= lpips_addnoise_th (the x0_t curve,
    or the x curve with `add_noise_from_xt`);
  * user-defined values short-circuit each.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from asyrp_official_torch.utils.assets import lpips_curve

__all__ = ["select_interval"]


def _first_at_threshold(curve: Dict[int, float], th: float) -> int:
    for t in sorted(curve):
        if curve[t] >= th:
            return t
    raise ValueError(f"no timestep reaches LPIPS threshold {th}")


def select_interval(
    dataset: str,
    cosine: float,
    *,
    lpips_edit_th: float = 0.33,
    lpips_addnoise_th: float = 0.1,
    add_noise_from_xt: bool = False,
    user_defined_t_edit: Optional[int] = None,
    user_defined_t_addnoise: Optional[int] = None,
    curve_x0_t: Optional[Dict[int, float]] = None,
    curve_x: Optional[Dict[int, float]] = None,
) -> Tuple[int, int]:
    """Returns (t_edit, t_addnoise)."""
    if user_defined_t_edit is not None and user_defined_t_addnoise is not None:
        return user_defined_t_edit, user_defined_t_addnoise
    if curve_x0_t is None:
        curve_x0_t = lpips_curve(dataset, "x0_t")
    if user_defined_t_edit is not None:
        t_edit = user_defined_t_edit
    else:
        t_edit = _first_at_threshold(curve_x0_t, lpips_edit_th * cosine)
    if user_defined_t_addnoise is not None:
        t_addnoise = user_defined_t_addnoise
    else:
        curve = curve_x0_t
        if add_noise_from_xt:
            curve = curve_x if curve_x is not None else lpips_curve(dataset, "x")
        t_addnoise = _first_at_threshold(curve, lpips_addnoise_th)
    return t_edit, t_addnoise
