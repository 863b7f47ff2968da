"""The port's fidelity gate and runbook, face alignment and tracing, on the
CPU, against the JAX package:

  * `pipelines/fidelity.compare_images` / `compare_output_dirs` against the
    JAX ones on the same directories (the filename intersection, the report
    keys, the values at `close_to_scale` 1e-4): identical images read
    exactly 0, no common name raises;
  * the runbook (`--run_fidelity`) through the port's CLI on `--device cpu`:
    a missing artefact list in one error; on a block trained by the port's
    CLI, outputs `fidelity/test_{0,1}.png`, held against the JAX CLI's
    outputs of the same recipe (`--fidelity_ref_dir`, `--lpips_ckpt`): the
    report under the gate (mean ≤ 0.01) and equal to the JAX
    `compare_output_dirs` on the same directories; a self-comparison reads
    exactly 0;
  * the alignment tests of tests/test_utils_aux.py against the port's
    `utils/align.py`;
  * `--trace_dir`: a tiny `--run_test` writes a torch.profiler trace that
    holds the port's spans.
"""
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from parity_utils import close_to_scale, tiny_lpips_ckpt

from asyrp_official_torch.compat.from_jax import lpips_state_dict_from_jax
from asyrp_official_torch.losses.lpips import LPIPS
from asyrp_official_torch.pipelines import fidelity as pfid
from asyrp_official_torch.utils import align as al
from asyrp_official_tpu.pipelines import fidelity as jfid
from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_pair(tmp_path_factory):
    """The random-weight `--lpips_ckpt` npz of the JAX pipeline tests, its
    JAX tree and the port's net from it."""
    path = tiny_lpips_ckpt(tmp_path_factory.mktemp("lp") / "lpips.npz")
    tree = np.load(path, allow_pickle=True)["params"].item()
    net = LPIPS()
    net.load_state_dict(lpips_state_dict_from_jax(tree))
    return path, tree, net.eval().requires_grad_(False)


def _save(arr, path):
    Image.fromarray(arr).save(path)


def _assert_reports_equal(got, want):
    assert sorted(got) == sorted(want) == ["max", "mean", "n", "per_image"]
    assert got["n"] == want["n"] == len(got["per_image"])
    if want["max"] > 0:
        close_to_scale(np.asarray(want["per_image"]), np.asarray(got["per_image"]), "per_image")
        close_to_scale(np.asarray([want["mean"], want["max"]]),
                       np.asarray([got["mean"], got["max"]]), "mean, max")
    else:
        assert got["max"] == 0.0


def test_compare_output_dirs_matches_jax(lpips_pair, tmp_path):
    _, tree, net = lpips_pair
    a, b = tmp_path / "ours", tmp_path / "theirs"
    a.mkdir(), b.mkdir()
    rng = np.random.RandomState(0)
    for i in range(10):  # two batches of 8
        img = (rng.rand(40, 40, 3) * 255).astype(np.uint8)
        _save(img, a / f"img_{i}.png")
        noisy = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
        _save(img if i % 3 == 0 else noisy, b / f"img_{i}.png")
    _save(np.zeros((40, 40, 3), np.uint8), b / "extra.png")
    for size in (None, 64):
        got = pfid.compare_output_dirs(str(a), str(b), net, size=size)
        _assert_reports_equal(got, jfid.compare_output_dirs(str(a), str(b), tree, size=size))
        assert got["n"] == 10 and got["max"] > 0 and got["per_image"][0] == 0.0
    same = pfid.compare_output_dirs(str(a), str(a), net)
    assert same["mean"] == same["max"] == 0.0


def test_no_common_filename_raises(lpips_pair, tmp_path):
    _, _, net = lpips_pair
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    _save(np.zeros((8, 8, 3), np.uint8), a / "only_a.png")
    _save(np.zeros((8, 8, 3), np.uint8), b / "only_b.png")
    with pytest.raises(ValueError, match="no matching filenames"):
        pfid.compare_output_dirs(str(a), str(b), net)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsf")
    write_tiny_workspace(str(root))
    return root


def _argv(ws, side, exp, extra, random_weights=True):
    return tiny_base_argv(str(ws / "tiny.yml"), str(ws / "imgs"), str(ws / side),
                          str(ws / side / "runs" / exp), allow_random_weights=random_weights,
                          extra=list(extra) + (["--device", "cpu"] if side == "port" else []))


def _port_main(argv):
    from asyrp_official_torch.cli.main import main

    return main(argv)


def test_fidelity_fails_fast_with_full_artifact_list(ws, caplog):
    rc = _port_main(_argv(ws, "port", "fid_fail", [
        "--run_fidelity", "--fidelity_ref_dir", str(ws / "no_such_ref_dir")],
        random_weights=False))
    assert rc == 1
    msg = "\n".join(r.getMessage() + str(r.exc_info and r.exc_info[1]) for r in caplog.records)
    for artefact in ("base diffusion ckpt", "trained Δ checkpoint", "LPIPS weights",
                     "reference outputs"):
        assert artefact in msg, artefact


def _fidelity_dir(ws, side, exp):
    return ws / side / "runs" / f"{exp}_LC_CUSTOM_t999_ninv4_ngen4" / "fidelity"


@pytest.fixture(scope="module")
def trained(ws):
    """The tiny Δ trained by the port's CLI and by the JAX CLI (one
    recipe), then each one's fidelity outputs without a reference dir."""
    from asyrp_official_tpu.cli.main import main as j_main

    for side, main in (("port", _port_main), ("jax", j_main)):
        assert main(_argv(ws, side, "fid", ["--run_train", "--train_delta_block",
                                            "--do_test", "0"])) == 0, side
        assert main(_argv(ws, side, "fid", ["--run_fidelity", "--train_delta_block"])) == 0, side
        assert sorted(os.listdir(_fidelity_dir(ws, side, "fid"))) == ["test_0.png", "test_1.png"]
    return ws


def test_fidelity_runbook_against_the_jax_outputs(trained, lpips_pair):
    ws = trained
    ckpt, tree, _ = lpips_pair
    ours, jax_dir = _fidelity_dir(ws, "port", "fid"), _fidelity_dir(ws, "jax", "fid")
    # the JAX runbook writes each image as a one-image grid 8 columns wide
    # (34 x 265); the port writes the 32 x 32 image, as torchvision does
    theirs = ws / "jax_outputs"
    theirs.mkdir()
    for f in ("test_0.png", "test_1.png"):
        a, b = np.asarray(Image.open(ours / f)), np.asarray(Image.open(jax_dir / f))
        assert a.shape == (32, 32, 3) and b.shape == (34, 265, 3), f
        _save(b[1:33, 1:33], theirs / f)
        assert np.abs(a.astype(np.float32) - b[1:33, 1:33]).max() <= 1.0, f  # one 8-bit step

    assert _port_main(_argv(ws, "port", "fid", [
        "--run_fidelity", "--train_delta_block", "--fidelity_ref_dir", str(theirs),
        "--lpips_ckpt", ckpt])) == 0
    report = json.load(open(ours / "lpips_report.json"))
    _assert_reports_equal(report, jfid.compare_output_dirs(str(ours), str(theirs), tree))
    assert report["n"] == 2 and report["mean"] <= 0.01

    ref = ws / "port_self_ref"
    shutil.copytree(ours, ref)
    os.remove(ref / "lpips_report.json")
    assert _port_main(_argv(ws, "port", "fid", [
        "--run_fidelity", "--train_delta_block", "--fidelity_ref_dir", str(ref),
        "--lpips_ckpt", ckpt])) == 0
    report = json.load(open(ours / "lpips_report.json"))
    assert report["n"] == 2 and report["mean"] == report["max"] == 0.0


def test_trace_dir_writes_a_trace(trained):
    ws = trained
    trace_dir = ws / "trace"
    assert _port_main(_argv(ws, "port", "fid", [
        "--run_test", "--train_delta_block", "--do_train", "0", "--n_test_img", "1",
        "--bs_train", "1", "--trace_dir", str(trace_dir)])) == 0
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1, os.listdir(trace_dir)
    events = json.load(open(trace_dir / traces[0]))["traceEvents"]
    assert any("conv2d" in e.get("name", "") for e in events)
    # the port's own spans, on the same clock
    assert {"asyrp.step", "asyrp.eval"} <= {e.get("name") for e in events}


# --- the alignment tests of tests/test_utils_aux.py, on the port's copy ---

def _synthetic_landmarks():
    """Plausible 68-point layout on a 200x200 face."""
    lm = np.zeros((68, 2))
    lm[36:42] = [70, 80] + np.random.RandomState(0).rand(6, 2) * 6  # left eye
    lm[42:48] = [130, 80] + np.random.RandomState(1).rand(6, 2) * 6  # right eye
    lm[48:60] = [100, 140] + np.random.RandomState(2).rand(12, 2) * 14  # mouth
    return lm


def test_align_face_geometry():
    img = Image.fromarray((np.random.RandomState(0).rand(200, 200, 3) * 255).astype(np.uint8))
    out = al.align_face_from_landmarks(img, _synthetic_landmarks(), output_size=256)
    assert out.size == (256, 256)


def test_run_alignment_gated_without_dlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "dlib", None)  # import dlib raises ImportError
    p = str(tmp_path / "f.png")
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(p)
    with pytest.raises(ImportError):
        al.run_alignment(p)
    out = al.run_alignment(p, landmarks=_synthetic_landmarks())
    assert out.size == (256, 256)


def test_run_alignment_with_detector_callable(tmp_path):
    p = str(tmp_path / "f.png")
    Image.fromarray((np.random.RandomState(3).rand(200, 200, 3) * 255).astype(np.uint8)).save(p)
    calls = []

    def det(img):
        calls.append(img.size)
        return _synthetic_landmarks()

    out = al.run_alignment(p, detector=det)
    assert out.size == (256, 256)
    assert calls == [(200, 200)]


def test_dlib_detector_wiring(tmp_path, monkeypatch):
    lm = _synthetic_landmarks()

    class _Shape:
        def part(self, i):
            return types.SimpleNamespace(x=float(lm[i, 0]), y=float(lm[i, 1]))

    fake = types.SimpleNamespace(
        get_frontal_face_detector=lambda: (lambda arr, n: ["face0"]),
        shape_predictor=lambda path: (lambda arr, det: _Shape()),
    )
    monkeypatch.setitem(sys.modules, "dlib", fake)
    monkeypatch.setenv("ASYRP_TPU_SHAPE_PREDICTOR", str(tmp_path / "missing.dat"))
    with pytest.raises(FileNotFoundError, match="shape predictor"):
        al.dlib_detector()
    pred = tmp_path / "sp68.dat"
    pred.write_bytes(b"fake")
    monkeypatch.setenv("ASYRP_TPU_SHAPE_PREDICTOR", str(pred))
    p = str(tmp_path / "f.png")
    Image.fromarray((np.random.RandomState(4).rand(200, 200, 3) * 255).astype(np.uint8)).save(p)
    assert al.run_alignment(p).size == (256, 256)


def test_align_face_cli_flag_aligns_the_dataset_dirs(tmp_path, monkeypatch):
    """--align_face: every image of the custom dirs aligned once into
    {work_dir}/aligned/ (train dir == test dir), the args pointed there."""
    from asyrp_official_torch.cli.main import align_dataset_dirs, build_parser

    src = tmp_path / "faces"
    src.mkdir()
    for i in range(2):
        Image.fromarray((np.random.RandomState(i).rand(200, 200, 3) * 255).astype(np.uint8)).save(
            src / f"{i}.png")
    calls, real = [], al.run_alignment

    def run_alignment(path):
        calls.append(os.path.basename(path))
        return real(path, landmarks=_synthetic_landmarks())

    monkeypatch.setattr(al, "run_alignment", run_alignment)
    args = build_parser().parse_args([
        "--config", "custom.yml", "--align_face", "--work_dir", str(tmp_path),
        "--custom_train_dataset_dir", str(src), "--custom_test_dataset_dir", str(src)])
    align_dataset_dirs(args)
    assert args.custom_train_dataset_dir == args.custom_test_dataset_dir
    assert os.path.dirname(args.custom_train_dataset_dir) == str(tmp_path / "aligned")
    assert sorted(os.listdir(args.custom_train_dataset_dir)) == ["0.png", "1.png"]
    assert sorted(calls) == ["0.png", "1.png"]
