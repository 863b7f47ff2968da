"""The port's edit serving end to end on the CPU: `asyrp_official_torch.cli`
`--run_test --device cpu` on the recipe and workspace of
tests/test_serving_golden.py (tiny DDPM++, 4-step inversion and edited
generation, a seeded DeltaBlock) reproduces the JAX package's committed
golden grids tests/golden/tiny_serving_golden.npz within one uint8 level,
with under 1% of pixels differing. A subprocess runs the same recipe and
shows that the port never imports jax.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "tiny_serving_golden.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU, and these small
    convolutions then spend their time synchronising threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# writes the golden workspace, runs the port's CLI, checks that jax stayed out
SERVE = r'''
import os, sys
from asyrp_official_torch.cli.main import main
from asyrp_official_torch.models.delta import delta_block_init
from asyrp_official_tpu.compat.delta_ckpt import save_delta_checkpoint
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace

ws = sys.argv[1]
os.makedirs(os.path.join(ws, "checkpoint"), exist_ok=True)
cfg, imgs = write_tiny_workspace(ws)
save_delta_checkpoint(
    os.path.join(ws, "checkpoint", "golden_LC_CUSTOM_t999_ninv4_ngen4_0.pth"),
    blocks=[delta_block_init(hostrng.PRNGKey(123), 64, 128)], flavor="ddpm")
rc = main(tiny_base_argv(
    cfg, imgs, ws, os.path.join(ws, "runs", "exp"), bs_train=1, edit_attr=None,
    extra=["--run_test", "--train_delta_block", "--edit_attr", "smiling",
           "--load_from_checkpoint", "golden", "--do_train", "0"] + sys.argv[2:]))
assert rc == 0, rc
assert "jax" not in sys.modules, "the port imported jax"
print("SERVED_WITHOUT_JAX")
'''


def _serve(ws, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")  # see _one_torch_thread
    out = subprocess.run([sys.executable, "-c", SERVE, str(ws), *extra], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _grids(ws):
    from PIL import Image

    run_dir = os.path.join(ws, "runs", "exp_LC_CUSTOM_t999_ninv4_ngen4")
    out = {}
    for r, _, fs in os.walk(run_dir):
        for f in sorted(fs):
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(r, f), run_dir)] = np.asarray(
                    Image.open(os.path.join(r, f)))
    return out


def test_port_serving_reproduces_the_jax_golden_without_jax(tmp_path):
    assert "SERVED_WITHOUT_JAX" in _serve(tmp_path, "--device", "cpu")
    got = _grids(tmp_path)
    g = np.load(GOLDEN)
    assert sorted(g.files) == sorted(got), (sorted(g.files), sorted(got))
    for k in got:
        diff = np.abs(g[k].astype(np.int16) - got[k].astype(np.int16))
        assert diff.max() <= 1, (k, int(diff.max()))
        assert (diff > 0).mean() < 0.01, (k, float((diff > 0).mean()))


def _cli(tmp_path, *extra):
    from asyrp_official_torch.cli.main import main
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace

    cfg, imgs = write_tiny_workspace(str(tmp_path))
    return main(tiny_base_argv(cfg, imgs, str(tmp_path), str(tmp_path / "runs" / "exp"),
                               edit_attr=None, extra=list(extra)))


def test_cli_device_cuda_without_cuda_exits_1(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert _cli(tmp_path, "--run_test", "--train_delta_block", "--device", "cuda") == 1


@pytest.mark.parametrize("extra", [
    # --diff_style is served (tests/test_torch_style.py); --sp is not
    ["--run_test", "--train_delta_block", "--sp", "2"],
    ["--run_test", "--train_delta_block", "--dp", "2"],
    ["--run_train", "--train_delta_block", "--dp", "2"],
])
def test_cli_unported_modes_exit_1(tmp_path, extra):
    assert _cli(tmp_path, *extra, "--device", "cpu") == 1


def _rows_checkpoint(ws):
    """A Δh-rows checkpoint for the tiny DDPM++ UNet's [16, 16, 64]
    bottleneck, one seeded row per timestep of the 4-step grids."""
    from asyrp_official_torch.compat.delta_ckpt import save_delta_checkpoint
    from asyrp_official_torch.core.schedule import uniform_seq

    rng = np.random.RandomState(7)
    save_delta_checkpoint(
        os.path.join(ws, "checkpoint", "rows_LC_CUSTOM_t999_ninv4_ngen4_0.pth"),
        delta_rows={t: rng.randn(16, 16, 64).astype(np.float32)
                    for t in uniform_seq(4, 999)})


@pytest.mark.parametrize("extra", [
    # rows serving with the masked slerp (the DiffStyle region), as --masked_h
    ["--run_test", "--train_delta_h", "--load_from_checkpoint", "rows", "--delta_injection",
     "slerp", "--hs_coeff_origin_h", "0.5", "--use_mask"],
    # --target_class_num is read and ignored outside IMAGENET
    ["--run_train", "--train_delta_block", "--target_class_num", "1"],
    ["--run_test", "--train_delta_block", "--load_from_checkpoint", "golden",
     "--target_class_num", "1"],
])
def test_cli_formerly_unported_modes_match_the_jax_cli(tmp_path, extra):
    """Modes the port used to refuse run through its CLI on the tiny
    workspace and write what the JAX CLI writes: the same grids within one
    uint8 level, and for training the same trained block within 1e-4 of
    scale."""
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint
    from asyrp_official_tpu.cli.main import main as jax_main
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace

    from asyrp_official_torch.cli.main import main as port_main
    from parity_utils import close_to_scale

    out = {}
    for pkg, main, more in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        ws = tmp_path / pkg
        os.makedirs(ws / "checkpoint")
        cfg, imgs = write_tiny_workspace(str(ws))
        if "golden" in extra:
            from asyrp_official_torch.models.delta import delta_block_init
            from asyrp_official_torch.compat.delta_ckpt import save_delta_checkpoint
            from asyrp_official_torch.utils import hostrng

            save_delta_checkpoint(
                str(ws / "checkpoint" / "golden_LC_CUSTOM_t999_ninv4_ngen4_0.pth"),
                blocks=[delta_block_init(hostrng.PRNGKey(123), 64, 128)], flavor="ddpm")
        elif "rows" in extra:
            _rows_checkpoint(str(ws))
        argv = tiny_base_argv(cfg, imgs, str(ws), str(ws / "runs" / "exp"), bs_train=1,
                              edit_attr=None, extra=[*extra, "--save_x_origin", *more])
        assert main(argv) == 0, pkg
        out[pkg] = ws
    want, got = _grids(out["jax"]), _grids(out["port"])
    assert sorted(want) == sorted(got) and got, (sorted(want), sorted(got))
    for k in got:
        diff = np.abs(want[k].astype(np.int16) - got[k].astype(np.int16))
        assert diff.max() <= 1, (k, int(diff.max()))
    if "--run_train" in extra:
        name = os.path.join("checkpoint", "exp_LC_CUSTOM_t999_ninv4_ngen4_0.pth")
        (jb,), (tb,) = (load_delta_checkpoint(str(out[p] / name))["blocks"] for p in out)
        for g in jb:
            for k in jb[g]:
                close_to_scale(jb[g][k], tb[g][k], f"{g}/{k}")


def test_cli_missing_checkpoint_exits_1(tmp_path):
    assert _cli(tmp_path, "--run_test", "--train_delta_block", "--device", "cpu") == 1
