"""The port stands alone: it imports nothing of the JAX package.

  * a subprocess imports every module of `asyrp_official_torch`, runs the
    tiny `--run_train` recipe and then a tiny `--run_test` with the trained
    block on `--device cpu`, a tiny `--lpips` stage and a tiny
    `--run_fidelity` with a reference dir, then the tiny OpenAI-family
    `--run_train` (a learn_sigma UNet with 4-head attention, from a
    perturbed `.pt`), and finds neither `jax` nor any `asyrp_official_tpu`
    module in `sys.modules`;
  * an AST scan finds no import of either in the port's sources or in
    `chip_smoke.py`;
  * the data files the port copied (configs, assets) are byte-identical to
    the JAX package's, and the copied host functions (schedules, step
    tables, hostrng draws, interval selection, checkpoint names, the CLI
    parser's defaults, the face alignment, the LPIPS tsv writer, the ADM
    image crops) equal their originals on a few inputs.
"""
import ast
import inspect
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "asyrp_official_torch"
JAXPKG = REPO / "asyrp_official_tpu"

# runs the recipes of argv[1] (a JSON list of argv lists) in a process that
# imports every module of the port first
RUN = r'''
import importlib, json, pkgutil, sys
import asyrp_official_torch
from asyrp_official_torch.cli.main import main

for m in pkgutil.walk_packages(asyrp_official_torch.__path__, "asyrp_official_torch."):
    importlib.import_module(m.name)
for argv in json.loads(sys.argv[1]):
    assert main(argv) == 0, argv
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "asyrp_official_tpu")))
assert not bad, bad
print("PORT_STANDS_ALONE")
'''


def _openai_workspace(root: pathlib.Path) -> list:
    """The tiny OpenAI yml and a perturbed `.pt` of it (so eps is not zero);
    returns the training argv."""
    import torch
    import yaml

    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace
    from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

    _, imgs = write_tiny_workspace(str(root))
    cfg = str(root / "oai.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(OPENAI_TINY_CONFIG, f)
    spec = spec_from_config(OPENAI_TINY_CONFIG)
    torch.save(spec.state_dict_from_jax(perturbed(spec.init(hostrng.PRNGKey(5)))),
               root / "oai_unet.pt")
    return tiny_base_argv(cfg, imgs, str(root), str(root / "runs" / "oai"), extra=[
        "--run_train", "--train_delta_block", "--do_test", "0", "--save_train_image", "0",
        "--model_path", str(root / "oai_unet.pt"), "--device", "cpu"])


def test_port_trains_and_serves_without_the_jax_package(tmp_path):
    from PIL import Image

    from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace
    from parity_utils import tiny_lpips_ckpt

    cfg, imgs = write_tiny_workspace(str(tmp_path))
    exp = str(tmp_path / "runs" / "exp")
    train = tiny_base_argv(cfg, imgs, str(tmp_path), exp, extra=[
        "--run_train", "--train_delta_block", "--do_test", "0", "--n_iter", "2",
        "--save_train_image", "0", "--device", "cpu"])
    serve = tiny_base_argv(cfg, imgs, str(tmp_path), exp, extra=[
        "--run_test", "--train_delta_block", "--n_iter", "2", "--do_train", "0",
        "--device", "cpu"])
    lpips_npz = tiny_lpips_ckpt(tmp_path / "lpips.npz")
    lpips = tiny_base_argv(cfg, imgs, str(tmp_path), str(tmp_path / "runs" / "calib"), extra=[
        "--lpips", "--lpips_ckpt", lpips_npz, "--device", "cpu"])
    ref = tmp_path / "ref_outputs"
    ref.mkdir()
    for i in range(2):
        Image.fromarray(np.full((32, 32, 3), 60 * i, np.uint8)).save(ref / f"test_{i}.png")
    fidelity = tiny_base_argv(cfg, imgs, str(tmp_path), exp, extra=[
        "--run_fidelity", "--train_delta_block", "--n_iter", "2", "--fidelity_ref_dir", str(ref),
        "--lpips_ckpt", lpips_npz, "--device", "cpu"])
    train_oai = _openai_workspace(tmp_path / "oai")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    recipes = [train, serve, lpips, fidelity, train_oai]
    out = subprocess.run([sys.executable, "-c", RUN, json.dumps(recipes)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PORT_STANDS_ALONE" in out.stdout
    assert (tmp_path / "checkpoint" / "exp_LC_CUSTOM_t999_ninv4_ngen4_1.pth").exists()
    assert (tmp_path / "oai" / "checkpoint" / "oai_LC_CUSTOM_t999_ninv4_ngen4_0.pth").exists()
    grids = [g for g in (tmp_path / "runs").rglob("test_*.png") if g.parent.name != "fidelity"]
    assert len(grids) == 1, grids
    assert (tmp_path / "utils" / "celeba_LPIPS_distance_x0_t.tsv").exists()
    report = json.loads(next((tmp_path / "runs").rglob("lpips_report.json")).read_text())
    assert report["n"] == 2 and report["mean"] > 0


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 30
    bad = [(str(p.relative_to(REPO)), m) for p in sources for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "asyrp_official_tpu")]
    assert not bad, bad


COPIED_FILES = sorted(
    [f"configs/{p.name}" for p in (JAXPKG / "configs").glob("*.yml")]
    + ["assets/calibration_tables.npz", "assets/src_trg_prompts.json",
       "assets/clip_templates.json", "assets/imagenet_classes.json"])


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copied_data_file_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (JAXPKG / rel).read_bytes(), rel


def _pairs():
    """(name, port callable, JAX callable) over a few inputs each."""
    from asyrp_official_torch.cli import args as p_args
    from asyrp_official_torch.compat import delta_ckpt as p_ckpt
    from asyrp_official_torch.core import schedule as p_sched, steptable as p_tab
    from asyrp_official_torch.pipelines import interval as p_int
    from asyrp_official_torch.utils import assets as p_assets, hostrng as p_rng
    from asyrp_official_tpu.cli import main as j_cli
    from asyrp_official_tpu.compat import delta_ckpt as j_ckpt
    from asyrp_official_tpu.compat import torch_convert as j_conv
    from asyrp_official_tpu.core import schedule as j_sched, steptable as j_tab
    from asyrp_official_tpu.pipelines import interval as j_int
    from asyrp_official_tpu.utils import assets as j_assets, hostrng as j_rng
    from asyrp_official_torch.utils import align as p_align
    from asyrp_official_tpu.utils import align as j_align
    from asyrp_official_torch.data import datasets as p_data
    from asyrp_official_tpu.data import datasets as j_data

    def sched(m):
        s = m.make_schedule(num_timesteps=1000, beta_start=1e-4, beta_end=0.02,
                            var_type="fixedsmall")
        return [s.betas, s.alphas_cumprod, s.alphas_cumprod_ext, s.logvar]

    def tables(m):
        seq = [0, 250, 500, 750, 999]
        out = []
        for t in (m.inversion_table(seq), m.generation_table(seq, t_edit=500, t_addnoise=250)):
            out += [t.t, t.t_next, t.eta, t.use_delta, t.delta_idx, t.edit_prefix_len()]
        return out

    def rng(m):
        k = m.PRNGKey(7)
        ks = m.split(k, 5)
        return [ks, m.random_bits(ks[1], (3, 4)), m.uniform(ks[2], (16,), minval=-1.0, maxval=1.0)]

    def interval(m, a):
        return [m.select_interval("celeba", c, lpips_edit_th=0.33, lpips_addnoise_th=0.1)
                for c in (1.0, 0.8)] + [
            m.select_interval("church", 0.9, user_defined_t_edit=400),
            m.select_interval("celeba", 1.0, add_noise_from_xt=True,
                              curve_x=a.lpips_curve("celeba", "x"))]

    def defaults(m):
        return sorted(vars(m.build_parser().parse_args(["--config", "custom.yml"])).items())

    def flat(d):
        return [k for k in sorted(d)] + [np.asarray(d[k]) for k in sorted(d)]

    def openai_block(ckpt, to_tree):
        # an OpenAI-flavor DeltaBlock: JAX-layout tree -> torch keys -> tree
        tree = {"in_norm": {"scale": np.linspace(0.5, 1.5, 32, dtype=np.float32),
                            "bias": np.linspace(-1, 1, 32, dtype=np.float32)},
                "in_conv": {"w": np.arange(32 * 32, dtype=np.float32).reshape(32, 32),
                            "b": np.ones(32, np.float32)},
                "emb": {"w": np.arange(64 * 32, dtype=np.float32).reshape(64, 32) / 7,
                        "b": np.zeros(32, np.float32)},
                "out_norm": {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)},
                "out_conv": {"w": -np.eye(32, dtype=np.float32), "b": np.full(32, 2, np.float32)}}
        sd = ckpt.blocks_to_torch_sd(tree, "openai")
        back = to_tree(sd)
        return flat(sd) + flat({f"{g}.{k}": v for g, kv in back.items() for k, v in kv.items()})

    def align(m):
        # the geometry's source is the original's, line for line; its output
        # on a synthetic face, pixel for pixel
        from PIL import Image

        rng = np.random.RandomState(0)
        lm = np.zeros((68, 2))
        lm[36:42] = [70, 80] + rng.rand(6, 2) * 6
        lm[42:48] = [130, 80] + rng.rand(6, 2) * 6
        lm[48:60] = [100, 140] + rng.rand(12, 2) * 14
        img = Image.fromarray((rng.rand(200, 200, 3) * 255).astype(np.uint8))
        return [inspect.getsource(m.align_face_from_landmarks),
                np.asarray(m.align_face_from_landmarks(img, lm, output_size=128))]

    def imagenet_crops(m):
        # the ADM preprocessing, copied verbatim: the source, and the crops of
        # one odd-sized image (the random one from a seeded `random`)
        import random

        from PIL import Image

        img = Image.fromarray((np.random.RandomState(3).rand(150, 97, 3) * 255).astype(np.uint8))
        random.seed(11)
        return [inspect.getsource(m.center_crop_arr), inspect.getsource(m.random_crop_arr),
                m.center_crop_arr(img, 32), m.random_crop_arr(img, 32), m.random_crop_arr(img, 40)]

    def lpips_tsv(m):
        curves = {"x0_t": {999: 0.25, 499: 1.0 / 3.0}, "x_std": {999: 1e-9, 499: 0.0}}
        with tempfile.TemporaryDirectory() as d:
            m.write_lpips_tsv(d, "tiny", curves)
            return [(f, open(os.path.join(d, f), "rb").read()) for f in sorted(os.listdir(d))]

    return {
        "uniform_seq": (lambda: [p_sched.uniform_seq(n, 999) for n in (4, 40, 1000)],
                        lambda: [j_sched.uniform_seq(n, 999) for n in (4, 40, 1000)]),
        "train_seq": (lambda: [p_sched.train_seq(n, 999, te) for n, te in ((40, 513), (0, 900))],
                      lambda: [j_sched.train_seq(n, 999, te) for n, te in ((40, 513), (0, 900))]),
        "make_schedule": (lambda: sched(p_sched), lambda: sched(j_sched)),
        "step_tables": (lambda: tables(p_tab), lambda: tables(j_tab)),
        "hostrng": (lambda: rng(p_rng), lambda: rng(j_rng)),
        "select_interval": (lambda: interval(p_int, p_assets), lambda: interval(j_int, j_assets)),
        "checkpoint_name": (lambda: [p_ckpt.checkpoint_name("e", "CUSTOM", 999, 40, 40, 1, x)
                                     for x in (None, 3)],
                            lambda: [j_ckpt.checkpoint_name("e", "CUSTOM", 999, 40, 40, 1, x)
                                     for x in (None, 3)]),
        "parser_defaults": (lambda: defaults(p_args), lambda: defaults(j_cli)),
        "src_trg_prompts": (lambda: p_assets.src_trg_prompts()["smiling"],
                            lambda: j_assets.src_trg_prompts()["smiling"]),
        "openai_delta_block": (lambda: openai_block(p_ckpt, p_ckpt.convert_delta_block),
                               lambda: openai_block(j_ckpt, j_conv.convert_delta_block)),
        "align_face": (lambda: align(p_align), lambda: align(j_align)),
        "write_lpips_tsv": (lambda: lpips_tsv(p_assets), lambda: lpips_tsv(j_assets)),
        "imagenet_crops": (lambda: imagenet_crops(p_data), lambda: imagenet_crops(j_data)),
    }


@pytest.mark.parametrize("name", ["uniform_seq", "train_seq", "make_schedule", "step_tables",
                                  "hostrng", "select_interval", "checkpoint_name",
                                  "parser_defaults", "src_trg_prompts", "openai_delta_block",
                                  "align_face", "write_lpips_tsv", "imagenet_crops"])
def test_copied_function_equals_the_original(name):
    port, ref = _pairs()[name]
    got, want = port(), ref()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
        else:
            assert g == w, (name, g, w)
