"""The port's remaining library modules against the JAX package's, on the
CPU: the ResNet-18 feature pyramid (`losses/resnet18.py`) from one random
torchvision-layout state dict with non-trivial BatchNorm statistics; the
shape report (`models/debug.py`, on the meta device) for every config of
`configs/`; the LMDB writer (`data/prepare_lmdb.py`) through a stand-in
`lmdb` module, whose keys and bytes both packages write alike and whose
LMDB the port's reader (`data/datasets.py` `CelebAHQLMDB`) reads back; and
the presets (`configs/presets.py`).

Tolerance: `close_to_scale` 1e-4 for the features.
"""
import multiprocessing
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from parity_utils import close_to_scale

from asyrp_official_torch.cli.args import load_config
from asyrp_official_torch.configs import presets as ppresets
from asyrp_official_torch.data import datasets as pdata
from asyrp_official_torch.data import prepare_lmdb as plmdb
from asyrp_official_torch.losses import resnet18 as pres
from asyrp_official_torch.models.debug import forward_shape_report as p_report
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_tpu.configs import presets as jpresets
from asyrp_official_tpu.data import prepare_lmdb as jlmdb
from asyrp_official_tpu.losses import resnet18 as jres
from asyrp_official_tpu.models.debug import forward_shape_report as j_report
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config

CONFIGS = sorted(f for f in os.listdir(os.path.join(os.path.dirname(pdata.__file__), os.pardir,
                                                    "configs")) if f.endswith(".yml"))


def _torchvision_sd(seed=0):
    """A random state dict in torchvision's resnet18 layout, fc excluded."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in pres.ResNet18().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.array(0, np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", "bias")):
            sd[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
        elif v.dim() == 1:  # BN weight
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            fan = int(np.prod(v.shape[1:]))
            sd[k] = (rng.randn(*v.shape) * fan ** -0.5).astype(np.float32)
    return sd


@pytest.mark.parametrize("batch", [1, 2])
def test_resnet18_features_match_jax(batch):
    sd = _torchvision_sd()
    model = pres.ResNet18()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.train()  # BN keeps its running statistics in either mode
    x = np.random.RandomState(batch).randn(batch, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        got = pres.resnet18_features(model, torch.from_numpy(x))
    want = jres.resnet18_features(jres.params_from_torch(sd), jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert [tuple(g.shape) for g in got] == [(batch, c, s, s) for c, s in ((128, 8), (256, 4),
                                                                          (512, 2))]
    for i, (g, w) in enumerate(zip(got, want)):
        close_to_scale(np.asarray(w).transpose(0, 3, 1, 2), g.numpy(), f"feat{8 * 2 ** i}")
    assert torch.equal(model(torch.from_numpy(x))[0], got[0])


def test_resnet18_init_is_seeded():
    a, b = pres.init(3), pres.init(3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.conv1.weight, pres.init(4).conv1.weight)


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_shape_report_matches_jax(config, capsys):
    cfg = load_config(config)
    got = p_report(spec_from_config(cfg), batch=2)
    want = j_report(j_spec_from_config(cfg), batch=2)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, g), (_, w) in zip(got, want):
        # the port reports NCHW, the JAX package NHWC
        w = (w[0], w[3], w[1], w[2]) if len(w) == 4 else w
        assert g == w, (config, name, g, w)
    assert "params (count)" in capsys.readouterr().out


class _Txn:
    def __init__(self, store, write):
        self.store, self.write = store, write

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def put(self, key, value):
        assert self.write
        self.store[bytes(key)] = bytes(value)

    def get(self, key):
        return self.store.get(bytes(key))


class _Env:
    def __init__(self, store):
        self.store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self, write=False):
        return _Txn(self.store, write)

    def close(self):
        pass


def _stand_in_lmdb():
    """An `lmdb` stand-in: one dict per path, in this process."""
    stores = {}
    mod = types.ModuleType("lmdb")
    mod.open = lambda path, **kw: _Env(stores.setdefault(os.path.abspath(path), {}))
    return mod, stores


def test_prepare_lmdb_writes_what_the_jax_writer_writes(tmp_path, monkeypatch):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(imgs / f"{i}.png")
    (imgs / "notes.txt").write_text("not an image")
    mod, stores = _stand_in_lmdb()
    monkeypatch.setitem(sys.modules, "lmdb", mod)
    # the JAX writer's pool forks; from this multithreaded process, spawn
    monkeypatch.setattr(jlmdb, "Pool", multiprocessing.get_context("spawn").Pool)
    sizes = (8, 16)
    n_p = plmdb.prepare(str(tmp_path / "port"), str(imgs), n_worker=1, sizes=sizes)
    n_j = jlmdb.prepare(str(tmp_path / "jax"), str(imgs), n_worker=1, sizes=sizes)
    assert n_p == n_j == 3
    port, jax_ = stores[str(tmp_path / "port")], stores[str(tmp_path / "jax")]
    assert port == jax_ and len(port) == 3 * len(sizes) + 1
    assert port[b"length"] == b"3"
    ds = pdata.CelebAHQLMDB(str(tmp_path / "port"), image_size=16)
    assert len(ds) == 3
    arr = ds[1]
    assert arr.shape == (16, 16, 3) and -1.0 <= arr.min() and arr.max() <= 1.0
    blob = plmdb.resize_and_encode(str(imgs / "1.png"), sizes=(16,))[0]
    assert port[b"16-00001"] == blob


def test_prepare_lmdb_without_lmdb_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    with pytest.raises(ImportError, match="lmdb"):
        plmdb.prepare(str(tmp_path / "db"), str(tmp_path))


def test_presets_equal_the_jax_package():
    assert ppresets.get_celeba_configs() == jpresets.get_celeba_configs()
    for extra in (None, ["--n_iter", "2"]):
        got = vars(ppresets.args_from_preset(ppresets.get_celeba_configs(), extra))
        want = vars(jpresets.args_from_preset(jpresets.get_celeba_configs(), extra))
        assert got.pop("device") == "cuda"  # the port's own flag
        assert got == want
