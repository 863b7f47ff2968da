"""The port's mesh (`parallel/mesh.py`): the guards of --dp / --sp /
--tp_spatial (`plan_mesh`, a pure function) case for case against the JAX
runner's texts (`tests/test_runner_dp.py` `test_sp_guards`,
`test_dp_divisibility_is_checked`, on its 8-device mesh: here a world of 8
processes), the port's own rules (the whole world, one process per GPU; the
bottleneck's rows), the runner's refusal without a process group,
`pad_to_multiple` against the JAX function, and a mesh's placement on one
process."""
import numpy as np
import pytest
import torch
import yaml

from asyrp_official_torch.cli.main import build_parser
from asyrp_official_torch.parallel import mesh as pmesh
from asyrp_official_torch.runner import AsyrpRunner
from asyrp_official_torch.utils.tinyws import tiny_base_argv, write_tiny_workspace
from asyrp_official_tpu.parallel import mesh as jmesh

# the JAX test's workspace: image 32, bs_train 2, 8 devices
IMAGE, BS, WORLD = 32, 2, 8


def plan(dp=0, sp=0, tp=False, world=WORLD, image=IMAGE, bs=BS, bottleneck=None):
    return pmesh.plan_mesh(dp, sp, tp, world, image, bs, bottleneck)


@pytest.mark.parametrize("flags, match", [
    (dict(dp=2, sp=2, tp=True), "exclusive"),
    (dict(dp=2, sp=5), "image_size"),       # 32 % 5 != 0
    (dict(dp=3, sp=2), "data"),             # bs_train=2 % 3 != 0
    (dict(sp=16), "does not divide"),       # 8 processes % 16 != 0
    (dict(sp=1), ">= 2"),                   # a silent no-op
    (dict(dp=-1, sp=3), "does not divide"),  # 'all' must mean ALL 8 processes
    (dict(dp=3), "must divide"),            # test_dp_divisibility_is_checked
])
def test_sp_and_dp_guards_match_the_jax_runner(flags, match):
    with pytest.raises(ValueError, match=match):
        plan(**flags)


@pytest.mark.parametrize("flags, world, want", [
    (dict(), 1, None),
    (dict(dp=2), 2, (2, 1)),
    (dict(dp=-1, bs=8), 8, (8, 1)),
    (dict(dp=4, tp=True), 4, (1, 4)),  # bs_train need not divide: no batch split
    (dict(dp=-1, tp=True), 8, (1, 8)),
    (dict(dp=2, sp=2), 4, (2, 2)),
    (dict(sp=2, bs=4), 8, (4, 2)),
    (dict(dp=1), 1, (1, 1)),
])
def test_plan_shapes(flags, world, want):
    assert plan(**flags, world=world) == want


@pytest.mark.parametrize("flags, world, match", [
    (dict(dp=2), 1, "torchrun --nproc_per_node 2"),   # no process group
    (dict(dp=2), 4, "whole world"),                   # two processes idle
    (dict(dp=2, sp=2), 8, "whole world"),
    (dict(dp=2, tp=True), 4, "whole world"),
    (dict(tp=True), 8, "requires --dp"),
])
def test_the_mesh_takes_every_process(flags, world, match):
    with pytest.raises(ValueError, match=match):
        plan(**flags, world=world)


def test_the_bottleneck_rows_must_divide():
    # custom.yml: 256^2, bottleneck 8^2: 8 ways hold one row each, 16 cannot
    assert plan(dp=8, tp=True, world=8, image=256, bottleneck=8) == (1, 8)
    with pytest.raises(ValueError, match="bottleneck"):
        plan(dp=16, tp=True, world=16, image=256, bottleneck=8)
    with pytest.raises(ValueError, match="bottleneck"):
        plan(dp=2, sp=4, world=8, image=32, bs=2, bottleneck=6)


def test_runner_refuses_dp_without_a_process_group(tmp_path):
    write_tiny_workspace(str(tmp_path))
    argv = tiny_base_argv(str(tmp_path / "tiny.yml"), str(tmp_path / "imgs"), str(tmp_path),
                          str(tmp_path / "runs" / "e"), extra=["--dp", "2", "--device", "cpu"])
    config = yaml.safe_load(open(tmp_path / "tiny.yml"))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        AsyrpRunner(build_parser().parse_args(argv), config, work_dir=str(tmp_path))
    # --dp 1 on one process is a 1 x 1 mesh: it serves as without the flag
    argv1 = argv[:-4] + ["--dp", "1", "--device", "cpu"]
    runner = AsyrpRunner(build_parser().parse_args(argv1), config, work_dir=str(tmp_path))
    assert (runner.mesh.data, runner.mesh.spatial) == (1, 1)


@pytest.mark.parametrize("b, m", [(1, 4), (3, 2), (4, 2), (5, 8), (8, 8)])
def test_pad_to_multiple_matches_jax(b, m):
    x = np.random.RandomState(b).randn(b, 3, 2).astype(np.float32)
    got, n = pmesh.pad_to_multiple(x, m)
    want, n_j = jmesh.pad_to_multiple(x, m)
    assert n == n_j == b
    np.testing.assert_array_equal(got, want)


def test_a_one_process_mesh_places_and_fetches_the_whole_batch():
    m = pmesh.make_mesh(1, 1)
    x = np.random.RandomState(0).randn(3, 4, 4, 2).astype(np.float32)
    t = pmesh.shard_batch(m, x)
    np.testing.assert_array_equal(pmesh.fetch(m, t), x)
    put, n = m.put_padded(x)
    assert n == 3 and tuple(put.shape) == x.shape
    assert m.noise_fn(torch.Generator(), x.shape) is None  # the sampler draws itself
    v = torch.arange(4.0, requires_grad=True)
    m.batch_mean(v).backward()
    np.testing.assert_array_equal(v.grad.numpy(), np.full(4, 0.25, np.float32))


def test_block_slicing_of_a_two_by_two_mesh():
    """rank r sits at (r // spatial, r % spatial): its batch rows and image rows."""
    x = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2, 1)
    for rank in range(4):
        m = pmesh.Mesh(2, 2, rank)
        d, s = divmod(rank, 2)
        np.testing.assert_array_equal(m.local(x), x[2 * d:2 * d + 2, 4 * s:4 * s + 4])
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.Mesh(2, 2, 0).local(x[:3])
