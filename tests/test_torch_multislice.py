"""The port's `parallel/multislice.py` against the JAX package's: the same
work shards of the same lists, and `combine_delta_means` on a 2-process
gloo group against the JAX function's single-process formula on the
summed Δh (float32 sums in another order: 1e-6 of scale)."""
import json

import numpy as np
import pytest

from parity_utils import close_to_scale
from torch_ranks import run_ranks

from asyrp_official_torch.parallel import multislice as P
from asyrp_official_tpu.parallel import multislice as J


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 13])
@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
def test_shard_work_matches_jax(n, count):
    items = [f"img{i}" for i in range(n)]
    shards = [P.shard_work(items, i, count) for i in range(count)]
    assert shards == [J.shard_work(items, i, count) for i in range(count)]
    assert sum(shards, []) == items  # contiguous, in order, nothing lost


def test_without_a_process_group_one_process_holds_everything():
    assert P.process_info() == (0, 1)
    assert P.shard_work(list(range(5))) == list(range(5))
    s = np.random.RandomState(0).randn(3, 4, 4, 2).astype(np.float32)
    np.testing.assert_array_equal(P.combine_delta_means(s, 3), J.combine_delta_means(s, 3))


WORKER = r'''
import json
import numpy as np
from asyrp_official_torch.parallel import multislice as P

out = ARGS[0]
sums = np.load(ARGS[1])
counts = json.loads(ARGS[2])
assert P.process_info() == (RANK, WORLD)
mean = P.combine_delta_means(sums[f"s{RANK}"], counts[RANK])
work = P.shard_work(list(range(7)))
if RANK == 0:
    np.savez(out, mean=mean)
np.save(out + f".work{RANK}.npy", np.asarray(work))
'''


def test_combine_delta_means_on_two_gloo_processes(tmp_path):
    rng = np.random.RandomState(1)
    sums = {f"s{r}": rng.randn(3, 8, 8, 4).astype(np.float32) for r in range(2)}
    counts = [2, 3]  # ragged: the harvest's last batch may be partial
    np.savez(tmp_path / "sums.npz", **sums)
    out = str(tmp_path / "mean.npz")
    run_ranks(WORKER, 2, [out, str(tmp_path / "sums.npz"), json.dumps(counts)], timeout=120)
    want = J.combine_delta_means(sums["s0"] + sums["s1"], sum(counts))
    close_to_scale(np.load(out)["mean"], want, "combined mean", bound=1e-6)
    assert [np.load(f"{out}.work{r}.npy").tolist() for r in range(2)] == [
        J.shard_work(list(range(7)), r, 2) for r in range(2)]
