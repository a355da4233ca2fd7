"""The port's logical-axis rules against the JAX package's, on the CPU.

``repro_torch.distributed.sharding.MeshInfo.spec`` over a ``FakeMesh`` (no
devices) equals JAX's ``MeshInfo.spec`` exactly for every ``(shape, axes)``
leaf of all ten configs' parameters (smoke and full width; JAX's shapes
through ``eval_shape``) on the 16x16, 2x16x16, 2x2, 2x1 and 1x1 meshes;
``LanguageModel.param_axes`` equals JAX's leaf for leaf; the seven
invariants of ``tests/test_sharding_rules.py`` hold for the port; the
placements of a nested dim; in a one-rank gloo group, ``constrain`` raises
for a plain tensor under a mesh and ``make_production_mesh`` raises at the
wrong world size; on four ranks a dim over ("pod", "data") holds its
blocks in JAX's order, and a checkpoint of it restores onto another mesh.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.distributed.sharding import MeshInfo as JaxMeshInfo  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro_torch.distributed.sharding import MeshInfo, constrain  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.utils import tree_flatten  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402

ARCHS = ["gemma-2b", "deepseek-7b", "rwkv6-1.6b", "h2o-danube-1.8b",
         "recurrentgemma-9b", "minicpm3-4b", "granite-moe-1b-a400m",
         "deepseek-v2-236b", "whisper-medium", "qwen2-vl-72b"]
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 2, "model": 1},
          {"data": 1, "model": 1}]


class FakeMesh:
    """Just enough of a Mesh for MeshInfo's spec logic (no devices)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


def info(**shape) -> MeshInfo:
    return MeshInfo(FakeMesh(shape))


def _module(arch):
    return arch.replace("-", "_").replace(".", "_")


def _is_axes(a):
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in a)


def _jax_leaves(cfg):
    """``{path: (shape, axes)}`` of JAX's parameters, shapes abstract."""
    model = JaxLM(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat = {}

    def walk(axes, shp, path):
        if _is_axes(axes):
            flat[path[1:]] = (tuple(shp.shape), axes)
        else:
            for k in axes:
                walk(axes[k], shp[k], f"{path}/{k}")

    walk(model.param_axes, shapes, "")
    return flat


def _port_leaves(cfg):
    model = LanguageModel(cfg, device="meta")
    shapes = dict(tree_flatten(model.param_shapes()))
    return {k: (shapes[k], a) for k, a in tree_flatten(model.param_axes)}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_on_every_leaf(arch):
    mod = _module(arch)
    jmod = importlib.import_module(f"repro.configs.{mod}")
    tmod = importlib.import_module(f"repro_torch.configs.{mod}")
    n = 0
    for make in ("smoke", "config"):
        jl = _jax_leaves(getattr(jmod, make)())
        tl = _port_leaves(getattr(tmod, make)())
        assert set(jl) == set(tl), sorted(set(jl) ^ set(tl))
        for shape in MESHES:
            ji = JaxMeshInfo(FakeMesh(shape))
            ti = info(**shape)
            for key, (jshape, jaxes) in jl.items():
                tshape, taxes = tl[key]
                assert (tshape, taxes) == (jshape, jaxes), key
                assert ti.spec(tshape, taxes) == tuple(ji.spec(jshape, jaxes)), \
                    (arch, make, shape, key)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    mod = _module(arch)
    jcfg = importlib.import_module(f"repro.configs.{mod}").smoke()
    tcfg = importlib.import_module(f"repro_torch.configs.{mod}").smoke()
    assert LanguageModel(tcfg, device="meta").param_axes == JaxLM(jcfg).param_axes


def _batch_spreads_over_pod_and_data():
    i = info(pod=2, data=16, model=16)
    assert i.spec((256, 4096), ("batch", "seq_act")) == (("pod", "data"),
                                                         "model")


def _divisibility_fallback_drops_axis():
    i = info(data=16, model=16)
    # 8 kv heads can't shard over 16-way model: dropped
    assert i.spec((32, 1024, 8, 128),
                  ("batch", None, "kv_heads", None)) == ("data",)
    # 32 kv heads can
    assert i.spec((32, 1024, 32, 128),
                  ("batch", None, "kv_heads", None)) == ("data", None, "model")


def _axis_used_once_per_tensor():
    i = info(data=16, model=16)
    # both dims want "model": first one wins, second drops
    assert i.spec((64, 64), ("heads", "mlp")) == ("model",)


def _batch_one_cannot_shard():
    i = info(data=16, model=16)
    assert i.spec((1, 524288), ("batch", "kv_seq")) == (None, "model")


def _partial_divisibility_multi_axis():
    i = info(pod=2, data=16, model=16)
    # batch 16: divisible by pod(2) then pod*data(32)? 16 % 32 != 0 -> pod only
    assert i.spec((16, 8), ("batch", None)) == ("pod",)
    # batch 64: 64 % 2 == 0, 64 % 32 == 0 -> both
    assert i.spec((64, 8), ("batch", None)) == (("pod", "data"),)


def _constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert constrain(x, "batch", "seq_act") is x


def _trailing_nones_trimmed():
    i = info(data=16, model=16)
    assert i.spec((32, 64, 64, 64), ("batch", None, None, None)) == ("data",)


@pytest.mark.parametrize("check", [
    _batch_spreads_over_pod_and_data, _divisibility_fallback_drops_axis,
    _axis_used_once_per_tensor, _batch_one_cannot_shard,
    _partial_divisibility_multi_axis, _constrain_noop_without_mesh,
    _trailing_nones_trimmed], ids=lambda f: f.__name__[1:])
def test_rules_invariants(check):
    check()


def test_placements_of_a_nested_dim():
    from torch.distributed.tensor import Replicate, Shard

    i = info(pod=2, data=16, model=16)
    assert i.placements(i.spec((64, 4096, 8), ("batch", "seq_act", None))) \
        == [Shard(0), Shard(0), Shard(1)]
    assert i.sharding((8, 3), ("heads", "mlp")) == [Replicate(), Replicate(),
                                                     Replicate()]


def test_no_silent_escape(tmp_path):
    """Under a mesh a plain tensor reaching ``constrain`` raises, a DTensor
    is redistributed; the production meshes refuse a world of one rank."""
    out = run_ranks("""
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.distributed.sharding import (constrain, replicate,
                                                      use_mesh_info)
        from repro_torch.launch.mesh import make_production_mesh
        info = small_mesh_info((1, 1), device_type="cpu")
        with use_mesh_info(info):
            try:
                constrain(torch.ones(4, 4), "batch", None)
                raise AssertionError("plain tensor passed constrain")
            except TypeError as e:
                assert "plain" in str(e), e
            y = constrain(replicate(torch.ones(4, 4)), "batch", None)
            assert list(y.placements) == [Replicate(), Replicate()]
        for multi in (False, True):
            try:
                make_production_mesh(multi_pod=multi, device_type="cpu")
                raise AssertionError("production mesh on one rank")
            except RuntimeError as e:
                assert "ranks" in str(e), e
        emit("ok", ok=np.ones(1))
    """, world=1, tmp_path=tmp_path)
    assert out["ok"]["ok"][0] == 1


def test_nested_shard_order_and_resharded_restore(tmp_path):
    """A dim over ("pod", "data") on a (pod 2, data 2, model 1) mesh: the
    rank at (p, d) holds block p * 2 + d, JAX's order for
    ``P(("pod", "data"))``; a checkpoint saved from that mesh and restored
    with ``sharding_fn`` onto (data 2, model 2) holds the same tensor, each
    rank the block of its new coordinate."""
    out = run_ranks("""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import use_mesh_info
        x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        big = small_mesh_info((2, 2, 1), ("pod", "data", "model"),
                              device_type="cpu")
        with use_mesh_info(big):
            d = big.distribute(x, ("batch", None))
            coord = big.mesh.get_coordinate()
            blocks = [torch.zeros(4, dtype=torch.long) for _ in range(WORLD)]
            mine = torch.tensor([coord[0], coord[1], int(d.to_local()[0, 0]),
                                 d.to_local().shape[0]])
            dist.all_gather(blocks, mine)
            mgr = CheckpointManager(os.path.join(DIR, "ck"), async_write=False)
            mgr.save(1, {"x": d})
            mgr.wait()
        small = small_mesh_info((2, 2), ("data", "model"), device_type="cpu")
        with use_mesh_info(small):
            spec = small.sharding((8, 3), ("batch", None))
            _, tree = mgr.restore_latest({"x": x}, device="cpu",
                                         sharding_fn=lambda key: spec)
            y = tree["x"]
            same = torch.equal(y.full_tensor(), x)
            row0 = int(y.to_local()[0, 0])
            coords = [torch.zeros(2, dtype=torch.long) for _ in range(WORLD)]
            dist.all_gather(coords, torch.tensor(
                [small.mesh.get_coordinate()[0], row0]))
        emit("o", blocks=torch.stack(blocks).numpy(), same=np.array([same]),
             restored=torch.stack(coords).numpy())
    """, world=4, tmp_path=tmp_path)["o"]
    for p, d, first, rows in out["blocks"]:
        assert rows == 2 and first == (p * 2 + d) * 2 * 3, out["blocks"]
    assert out["same"][0]
    for data, first in out["restored"]:  # batch over data only: 4 rows each
        assert first == data * 4 * 3, out["restored"]
