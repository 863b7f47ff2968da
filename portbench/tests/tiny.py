"""Cells of the benchmark at a tiny width for the CPU: the cell's own
driver, traffic and limits, with a 32 x 32 UNet of the same family (two
levels, 32 channels)."""
from __future__ import annotations

import copy

from portbench import bench

def tiny_config(family: str) -> dict:
    diffusion = {"beta_start": 0.0001, "beta_end": 0.02, "num_diffusion_timesteps": 1000}
    if family == "ddpmpp":
        return {"data": {"dataset": "CelebA_HQ", "category": "CUSTOM", "image_size": 32,
                         "channels": 3},
                "model": {"family": "ddpmpp", "in_channels": 3, "out_ch": 3, "ch": 32,
                          "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
                          "dropout": 0.0, "var_type": "fixedsmall", "resamp_with_conv": True},
                "diffusion": diffusion}
    return {"data": {"dataset": "AFHQ", "category": "AFHQ", "image_size": 32, "channels": 3},
            "model": {"family": "openai", "in_channels": 3, "out_ch": 6, "ch": 32,
                      "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
                      "dropout": 0.0, "var_type": "fixedsmall", "learn_sigma": True,
                      "num_head_channels": 32, "use_scale_shift_norm": True,
                      "resblock_updown": True},
            "diffusion": diffusion}


def cells():
    """The cells of BENCHMARK.json."""
    return [w["name"] for w in bench.load().data["workloads"]]


def full_cell(workload: str) -> bench.Cell:
    return bench.load().cell(workload)


def tiny_cell(workload: str, *, steps: int = 0, batch: int = 0) -> bench.Cell:
    """`workload` at a tiny width; `steps` > 0 shortens the chains, `batch`
    > 0 sets a request's batch."""
    cell = copy.deepcopy(full_cell(workload))
    cell.config = tiny_config(cell.config["model"]["family"])
    tr = cell.traffic
    tr.update(pool=4, warmup=0)
    if batch:
        tr["batch"] = batch
    if steps:
        tr.update(n_inv_step=steps, n_test_step=steps)
    return cell
