"""Bundled run presets — the port's copy of the JAX package's
`configs/presets.py` (`tests/test_torch_boundary.py` holds it equal to the
original).

The reference ships one orphan preset module, `configs/celeba.py`
(`get_celeba_configs()`): a ConfigDict for a `run_each_layer_clip`
experiment mode that no reference entry point dispatches. It is kept here
as a plain dict — same keys, same values — consumable by the CLI via
``args_from_preset``; the mode itself stays undispatched, and the preset's
standard keys (exp/attr/step counts/loss weights/seed/...) drive a normal
Asyrp run.

The reference sets `exp` twice; the dict literal keeps the surviving value
('./runs/').
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["get_celeba_configs", "args_from_preset"]


def get_celeba_configs() -> Dict[str, Any]:
    """== reference configs/celeba.py:7-50, as a plain dict."""
    return {
        "run_each_layer_clip": True,  # vestigial: undispatched in reference too
        "config": "celeba.yml",
        "edit_attr": "smiling",
        "do_train": 1,
        "do_test": 1,
        "n_train_img": 100,
        "n_test_img": 20,
        "n_iter": 4,
        "bs_train": 4,
        "t_0": 999,
        "n_inv_step": 40,
        "n_train_step": 40,
        "n_test_step": 40,
        "get_h_num": 1,
        "lr_latent_clr": 1e-1,  # vestigial knob (reference LC experiments)
        "id_loss_w": 1,
        "clip_loss_w": 1,
        "l1_loss_w": 3,
        "maintain": 295,  # vestigial knob
        "save_train_image_step": 6,
        "interpolation_step": 8,
        "retrain": 1,
        "scheduler_step_size": 4,
        "aimed_index": "8",  # vestigial knob
        # defaults block (reference :36-42; the second `exp` wins)
        "seed": 1234,
        "exp": "./runs/",
        "comment": "",
        "verbose": "info",
        "ni": 1,
        "align_face": 1,
        "sample_type": "ddim",
    }


def args_from_preset(preset: Dict[str, Any], extra=None):
    """Turn a preset dict into parsed CLI args: keys that the CLI parser
    knows become `--key value` pairs (so all parser-side validation and
    derived exp naming still apply); unknown/vestigial-only keys are carried
    onto the namespace verbatim, mirroring how the reference's ConfigDict
    would hand them to a consumer."""
    from asyrp_official_torch.cli.main import build_parser

    parser = build_parser()
    known = {a.dest for a in parser._actions}
    argv = []
    for k, v in preset.items():
        # align_face is INERT in the reference (parsed, never dispatched) but
        # ACTIVE here (the runner runs dlib FFHQ alignment) — routing
        # the preset's 1 through the live flag would rewrite the dataset
        # dirs, something no reference run of this preset ever did. Keep the
        # parser default (0 = the reference's effective behavior); opt in
        # explicitly via `extra=["--align_face", "1"]` if alignment is wanted.
        if k in known and k != "align_face":
            argv += [f"--{k}", str(v)]
    argv += list(extra or [])
    args = parser.parse_args(argv)
    for k, v in preset.items():
        if k not in known:
            setattr(args, k, v)
    return args
