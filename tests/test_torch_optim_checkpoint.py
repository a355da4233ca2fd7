"""The port's data pipeline, AdamW and checkpoint manager against the JAX
package: ``TokenDataset`` batches byte for byte, six AdamW updates on a
gemma-2b smoke tree (new params, ``m`` and ``v`` within 1e-6 relative of
each leaf's largest value, ``lr`` within one f32 ulp), the eight tests of
``tests/test_optim_checkpoint.py`` on the port, and checkpoints that cross
between the two packages bit for bit."""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.data import TokenDataset as JaxTokenDataset  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.optim import AdamW, OptConfig, cosine_schedule  # noqa: E402
from repro_torch.utils import tree_flatten, tree_map  # noqa: E402

PAIRS = [("2024-01/all", 0), ("2024-01/all", 7), ("2023-11/news", 3)]


@pytest.mark.parametrize("vocab", [512, 256000])
@pytest.mark.parametrize("partition,step", PAIRS)
def test_token_dataset_batches_are_byte_identical(vocab, partition, step):
    kw = dict(vocab_size=vocab, seq_len=48, global_batch=3, partition=partition)
    ours, ref = TokenDataset(**kw).batch(step), JaxTokenDataset(**kw).batch(step)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        assert ours[k].tobytes() == ref[k].tobytes(), k


# --------------------------------------------------------------------- AdamW


def _gemma_tree():
    """A gemma-2b smoke parameter tree (numpy), every leaf moved off its
    init value by 0.05 x a seeded normal, so the zero-initialised norm
    scales show their weight decay."""
    cfg = importlib.import_module("repro.configs.gemma_2b").smoke()
    tree = jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    return cfg, jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


def _grads(tree, step):
    """Seeded gradients of global norm 0.5, but 50 at step 2 (clipping on)."""
    rng = np.random.RandomState(100 + step)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                     tree)
    norm = np.sqrt(sum(float(np.sum(np.square(x))) for x in jax.tree.leaves(g)))
    target = 50.0 if step == 2 else 0.5
    return jax.tree.map(lambda x: (x * (target / norm)).astype(np.float32), g)


def test_adamw_update_matches_jax_over_six_steps():
    """Steps 1-6 with warmup 2 and decay 4: warmup, the cosine region, its
    end and two steps past it; clipping acts at step 3 (grad norm 50)."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=4, grad_clip=1.0,
              weight_decay=0.1)
    jopt, opt = JaxAdamW(JaxOptConfig(**kw)), AdamW(OptConfig(**kw))
    cfg, tree = _gemma_tree()
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tcfg = importlib.import_module("repro_torch.configs.gemma_2b").smoke()
    params = params_from_numpy(tree, tcfg, "cpu")
    state = opt.init(params)
    update = jax.jit(jopt.update)
    for i in range(6):
        g = _grads(tree, i)
        jparams, jstate, jstats = update(jax.tree.map(jnp.asarray, g), jstate,
                                         jparams)
        # copies: the port clips its gradients in place, and jnp.asarray
        # may share the numpy buffers JAX's asynchronous update still reads
        params, state, stats = opt.update(
            tree_map(torch.tensor, g), state, params)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        lr_j, lr_t = np.float32(jstats["lr"]), np.float32(stats["lr"].item())
        assert abs(lr_t - lr_j) <= np.spacing(lr_j), (i, lr_t, lr_j)
        clipped = float(jstats["grad_norm"]) > 1.0
        assert clipped == (i == 2)
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-6)
        for name, ours, ref in (("params", params, jparams),
                                ("m", state["m"], jstate["m"]),
                                ("v", state["v"], jstate["v"])):
            for (path, t), r in zip(tree_flatten(ours), jax.tree.leaves(ref)):
                r = np.asarray(r)
                np.testing.assert_allclose(
                    t.numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max(),
                    err_msg=f"step {i + 1} {name}/{path}")


def test_adamw_decays_stacked_vectors_as_jax_does():
    """With zero gradients an update is weight decay alone: every leaf of
    stored rank >= 2 -- a scanned segment's stacked norm scales (L, d)
    included -- shrinks by (1 - lr * wd); the rank-1 final norm scale stays."""
    kw = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=4, weight_decay=0.1)
    opt = AdamW(OptConfig(**kw))
    _, tree = _gemma_tree()
    tcfg = importlib.import_module("repro_torch.configs.gemma_2b").smoke()
    params = params_from_numpy(tree, tcfg, "cpu")
    before = tree_map(torch.clone, params)
    state = opt.init(params)
    zeros = tree_map(torch.zeros_like, params)
    params, _, stats = opt.update(zeros, state, params)
    lr = stats["lr"]
    scale = before["seg0"]["sub0"]["norm1"]["scale"]
    assert scale.ndim == 2
    torch.testing.assert_close(params["seg0"]["sub0"]["norm1"]["scale"],
                               scale - lr * (0.1 * scale), rtol=0, atol=0)
    assert torch.equal(params["final_norm"]["scale"],
                       before["final_norm"]["scale"])
    jopt = JaxAdamW(JaxOptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    jnew, _, _ = jopt.update(jax.tree.map(jnp.zeros_like, jp), jopt.init(jp), jp)
    for (path, t), r in zip(tree_flatten(params), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0, err_msg=path)


# ------------------------------------- tests/test_optim_checkpoint.py, ported


def test_adamw_converges_on_quadratic():
    opt = AdamW(OptConfig(peak_lr=0.1, warmup_steps=5, decay_steps=200,
                          weight_decay=0.0, grad_clip=10.0))
    target = {"w": torch.tensor([3.0, -2.0, 0.5]), "b": torch.tensor(1.5)}
    params = {"w": torch.zeros(3), "b": torch.zeros(())}
    state = opt.init(params)
    for _ in range(150):
        grads = {"w": 2 * (params["w"] - target["w"]),
                 "b": 2 * (params["b"] - target["b"])}
        params, state, stats = opt.update(grads, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target["w"].numpy(),
                               atol=1e-2)


def test_grad_clipping_bounds_update():
    opt = AdamW(OptConfig(peak_lr=1.0, warmup_steps=0, decay_steps=10,
                          grad_clip=1.0, weight_decay=0.0))
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, stats = opt.update(grads, state, params)
    assert float(stats["grad_norm"]) > 1e5  # pre-clip norm reported


def test_cosine_schedule_shape():
    cfg = OptConfig(peak_lr=1.0, min_lr_ratio=0.1, warmup_steps=10,
                    decay_steps=100)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 55, 100, 200)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 <= lrs[3] <= 1.0
    assert abs(lrs[4] - 0.1) < 1e-6
    assert abs(lrs[5] - 0.1) < 1e-6  # clamped past decay end


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    mgr.save(10, tree, metadata={"note": "x"})
    assert mgr.latest_step() == 10
    restored = mgr.restore(10, tree, device="cpu")
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nest"]["b"], tree["nest"]["b"])
    assert mgr.metadata(10)["note"] == "x"


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    tree = {"a": torch.ones(128)}
    mgr.save(5, tree)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    tree = {"a": torch.ones(4)}
    mgr.save(1, tree)
    # fake a torn write: step dir without COMMITTED marker
    os.makedirs(tmp_path / "step_00000002")
    assert mgr.latest_step() == 1


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(1, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": torch.ones(5)}, device="cpu")


# ----------------------------------------------- checkpoints across packages


def test_async_save_is_a_snapshot(tmp_path):
    """The writer thread writes the tree as it was at ``save``, although
    the optimizer overwrites the live tensors in place right after."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    live = {"a": torch.ones(1 << 16)}
    mgr.save(1, live)
    live["a"].mul_(3.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, live, device="cpu")["a"],
                       torch.ones(1 << 16))


def _train_state():
    """A gemma-2b smoke train state as numpy: params, moments, step."""
    _, tree = _gemma_tree()
    rng = np.random.RandomState(3)
    rand = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    return {"params": tree,
            "opt_state": {"m": jax.tree.map(rand, tree),
                          "v": jax.tree.map(lambda a: np.abs(rand(a)), tree),
                          "step": np.asarray(7, np.int32)}}


def _same_bits(a: dict, b: dict) -> None:
    fa, fb = dict(tree_flatten(a)), dict(tree_flatten(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_jax_checkpoint_restores_into_port(tmp_path):
    state = _train_state()
    JaxCheckpointManager(str(tmp_path), async_write=False).save(
        7, jax.tree.map(jnp.asarray, state), metadata={"arch": "gemma-2b"})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7 and mgr.metadata(7) == {"arch": "gemma-2b"}
    like = tree_map(torch.from_numpy, state)
    step, got = mgr.restore_latest(like, device="cpu")
    assert step == 7
    assert got["opt_state"]["step"].dtype == torch.int32
    _same_bits(tree_map(lambda t: t.numpy(), got), state)


def test_port_checkpoint_restores_into_jax(tmp_path):
    state = _train_state()
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, tree_map(torch.from_numpy, state),
             metadata={"arch": "gemma-2b"})
    mgr.wait()
    jmgr = JaxCheckpointManager(str(tmp_path))
    assert jmgr.latest_step() == 7 and jmgr.metadata(7) == {"arch": "gemma-2b"}
    got = jmgr.restore(7, jax.tree.map(jnp.asarray, state))
    _same_bits(jax.tree.map(np.asarray, got), state)


def test_manifests_of_both_packages_agree(tmp_path):
    """Same keys, shapes, dtypes and checksums in ``manifest.json``."""
    state = _train_state()
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        7, tree_map(torch.from_numpy, state))
    JaxCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        7, jax.tree.map(jnp.asarray, state))
    arrays = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "step_00000007" / "manifest.json") as f:
            arrays[name] = json.load(f)["arrays"]
    assert "params/seg0/sub0/core/w_q" in arrays["port"]
    assert "opt_state/step" in arrays["port"]
    assert arrays["port"] == arrays["jax"]


def test_bridged_params_round_trip_through_port_checkpoint(tmp_path):
    """params_to_numpy of a restored port tree equals the JAX tree."""
    state = _train_state()
    tcfg = importlib.import_module("repro_torch.configs.gemma_2b").smoke()
    params = params_from_numpy(state["params"], tcfg, "cpu")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"params": params})
    got = mgr.restore(1, {"params": params}, device="cpu")["params"]
    _same_bits(params_to_numpy(got), state["params"])
