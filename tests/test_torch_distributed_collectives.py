"""The port's collectives on gloo ranks against numpy and the JAX package.

* ``compressed_psum`` on 4 ranks, ``g`` (4, 64) from ``RandomState(0)``: the
  int32 totals, the mean and each rank's new error equal a numpy
  transcription of ``repro/distributed/collectives.py:33-53`` exactly; one
  round's error is at most the scale; 20 rounds of error feedback average
  to the true mean (``atol 5e-3``, ``tests/test_multidevice.py:137-146``);
  JAX's ``compressed_psum`` under ``shard_map`` on 4 forced host devices (a
  subprocess) gives the same mean.
* ``pipeline_apply`` on 4 ranks, 6 micro-batches of 2 x 8 through
  ``tanh(h @ w + b)``: outputs against JAX's sequential reference (1e-5),
  and the gradients of ``sum(out**2)`` against sequential autograd and JAX.
* The MoE capacity path on a one-rank gloo mesh, granite smoke with B*S
  above a lowered ``_SMALL_T``: at ``capacity_factor = E / top_k`` it
  equals ``_moe_dense`` (layer and loss, 1e-5; gradients 1e-5 of max |g|);
  at 1.25 each layer's dropped (token, slot) count equals a numpy count;
  ``_capacity`` equals JAX's over a grid of token counts.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.granite_moe_1b_a400m import smoke as jax_granite  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs.granite_moe_1b_a400m import smoke as granite  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _g():
    return np.random.RandomState(0).randn(4, 64).astype(np.float32)


def _np_compressed(xs):
    """``compressed_psum`` over the rows of ``xs`` (one per rank), in numpy
    f32: (totals, scale, mean, per-rank new errors)."""
    x32 = xs.astype(np.float32)
    scale = np.float32(np.max(np.abs(x32)) / np.float32(127.0))
    scale = scale if scale > 0 else np.float32(1.0)
    q = np.clip(np.round(x32 / scale), -127, 127).astype(np.int32)
    total = q.sum(axis=0).astype(np.int32)
    mean = total.astype(np.float32) * scale / np.float32(len(xs))
    err = x32 - q.astype(np.float32) * scale
    return total, scale, mean.astype(np.float32), err


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    np.save(d / "g.npy", _g())
    return run_ranks("""
        from repro_torch.distributed.collectives import (compressed_psum,
                                                         quantized_sum)
        g = torch.from_numpy(np.load(os.path.join(DIR, "g.npy"))[RANK])
        group = dist.group.WORLD
        q, total, scale = quantized_sum(g, group)
        m1, e1 = compressed_psum(g, group)
        errs = [torch.empty_like(e1) for _ in range(WORLD)]
        dist.all_gather(errs, e1)
        e = torch.zeros_like(g)
        est = torch.zeros_like(g)
        for _ in range(20):
            m, e = compressed_psum(g, group, e)
            est = est + m
        # a transposed view, as a gradient from a local product can be
        _, t_total, _ = quantized_sum(g.reshape(8, 8).t(), group)
        emit("c", total=total.numpy(), scale=scale.numpy(), mean=m1.numpy(),
             errors=torch.stack(errs).numpy(), avg=(est / 20).numpy(),
             t_total=t_total.numpy(), t_dense=np.array(t_total.is_contiguous()))
    """, world=4, tmp_path=d)["c"]


def test_compressed_psum_matches_numpy_exactly(compressed):
    total, scale, mean, err = _np_compressed(_g())
    np.testing.assert_array_equal(compressed["total"], total)
    assert compressed["scale"].dtype == np.float32
    assert compressed["scale"] == scale
    np.testing.assert_array_equal(compressed["mean"], mean)
    np.testing.assert_array_equal(compressed["errors"], err)


def test_quantized_sum_of_a_transposed_view(compressed):
    """The all-reduce's buffer is dense whatever the input's layout: NCCL
    refuses a strided one (gloo, here, takes it), and a gradient from a
    product on local shards may be a transposed view."""
    total, _, _, _ = _np_compressed(_g())
    assert bool(compressed["t_dense"])
    np.testing.assert_array_equal(compressed["t_total"],
                                  total.reshape(8, 8).T)


def test_compressed_psum_error_bounds(compressed):
    g = _g()
    true_mean = g.mean(axis=0)
    scale = float(np.max(np.abs(g)) / 127.0)
    err1 = float(np.max(np.abs(compressed["mean"] - true_mean)))
    assert err1 <= scale + 1e-6, (err1, scale)
    # error feedback: the estimates of repeated rounds of the same gradient
    # average to the true mean (residual carrying)
    np.testing.assert_allclose(compressed["avg"], true_mean, atol=5e-3)


def test_compressed_psum_matches_jax(compressed, tmp_path):
    np.save(tmp_path / "g.npy", _g())
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import inspect
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.distributed.collectives import compressed_psum
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        nocheck = ({{"check_vma": False}} if "check_vma" in
                   inspect.signature(shard_map).parameters
                   else {{"check_rep": False}})
        mesh = jax.make_mesh((4,), ("pod",))
        g = jnp.asarray(np.load({str(tmp_path / "g.npy")!r}))

        def f(g):
            m, _ = compressed_psum(g[0], "pod", None)
            return m[None]

        m = shard_map(f, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"),
                      **nocheck)(g)
        np.save({str(tmp_path / "jax_mean.npy")!r}, np.asarray(m))
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=180, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    jax_mean = np.load(tmp_path / "jax_mean.npy")
    for row in jax_mean:  # every rank holds the mean
        np.testing.assert_allclose(compressed["mean"], row, rtol=0, atol=1e-7)


N_STAGES, N_MICRO, MB, D = 4, 6, 2, 8


def _pipeline_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(N_STAGES, D, D) * 0.3).astype(np.float32)
    b = np.full((N_STAGES, D), 0.01, np.float32)
    x = rng.randn(N_MICRO, MB, D).astype(np.float32)
    return w, b, x


def test_pipeline_matches_sequential(tmp_path):
    w, b, x = _pipeline_inputs()
    np.savez(tmp_path / "pipe.npz", w=w, b=b, x=x)
    got = run_ranks("""
        from repro_torch.distributed.pipeline import pipeline_apply
        z = np.load(os.path.join(DIR, "pipe.npz"))
        w, b, x = (torch.from_numpy(z[k]).requires_grad_(True)
                   for k in ("w", "b", "x"))
        mesh = small_mesh_info((WORLD,), ("model",), device_type="cpu").mesh

        def stage_fn(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        out = pipeline_apply(stage_fn, {"w": w, "b": b}, x, mesh, axis="model")
        gw, gb, gx = torch.autograd.grad((out ** 2).sum(), [w, b, x])
        for g in (gw, gb, gx):  # each rank holds its own stage's share
            dist.all_reduce(g)
        # sequential autograd on the same weights
        w2, b2, x2 = (t.detach().clone().requires_grad_(True) for t in (w, b, x))
        h = x2
        for i in range(WORLD):
            h = stage_fn({"w": w2[i], "b": b2[i]}, h)
        sw, sb, sx = torch.autograd.grad((h ** 2).sum(), [w2, b2, x2])
        emit("p", out=out.detach().numpy(), gw=gw.numpy(), gb=gb.numpy(),
             gx=gx.numpy(), seq=h.detach().numpy(), sw=sw.numpy(),
             sb=sb.numpy(), sx=sx.numpy())
    """, world=N_STAGES, tmp_path=tmp_path)["p"]

    def seq(w, b, x):
        h = x
        for i in range(N_STAGES):
            h = jnp.tanh(h @ w[i] + b[i])
        return h

    ref = seq(w, b, x)
    np.testing.assert_allclose(got["out"], np.asarray(ref), rtol=1e-5, atol=1e-5)
    jg = jax.grad(lambda w, b, x: jnp.sum(seq(w, b, x) ** 2),
                  argnums=(0, 1, 2))(w, b, x)
    for name, j in zip(("gw", "gb", "gx"), jg):
        np.testing.assert_allclose(got[name], got["s" + name[1]], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[name], np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def capacity_one_rank(tmp_path_factory):
    d = tmp_path_factory.mktemp("capacity")
    return run_ranks("""
        from repro_torch.configs.granite_moe_1b_a400m import smoke
        from repro_torch.distributed.sharding import distribute_tree, use_mesh_info
        from repro_torch.models import LanguageModel, moe
        from repro_torch.utils import tree_leaves, tree_map

        moe._SMALL_T = 64
        B, S = 4, 32
        info = small_mesh_info((1, 1), device_type="cpu")
        out = {}
        for tag, cf in (("full", None), ("drop", 1.25)):
            cfg = smoke().scaled(compute_dtype="float32")
            cfg = cfg.scaled(capacity_factor=cf or cfg.n_experts / cfg.top_k)
            model = LanguageModel(cfg, device="cpu")
            params = model.init(0)
            g = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
                     for k in ("tokens", "targets")}
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            ref, rm = model.train_loss(params, batch)
            rg = torch.autograd.grad(ref, leaves)
            # a direction shared by every token skews the routing, so the
            # 1.25 capacity drops assignments
            x = (torch.randn(B, S, cfg.d_model, generator=g)
                 + 2.0 * torch.randn(cfg.d_model, generator=g))
            p_moe = {k: v.detach()[0] for k, v in params["seg0"]["sub0"]["moe"].items()}
            y_dense, aux_dense = moe._moe_dense(p_moe, cfg, x)
            with use_mesh_info(info):
                moe.PATH_CALLS.update(dense=0, shard_map=0)
                moe.DROPS = []
                dp = distribute_tree(tree_map(lambda t: t.detach(), params),
                                     model.param_axes, info)
                dl = [p.requires_grad_(True) for p in tree_leaves(dp)]
                db = {k: info.distribute(v, ("batch", "seq_act"))
                      for k, v in batch.items()}
                tot, m = model.train_loss(dp, db)
                drops = [int(a) for a, _ in moe.DROPS]
                gs = torch.autograd.grad(tot, dl)
                calls = dict(moe.PATH_CALLS)
                moe.DROPS = []
                dpm = {k: info.distribute(v, (None,) * v.ndim) for k, v in p_moe.items()}
                y_cap, aux_cap = moe.apply_moe(dpm, cfg, info.distribute(x, (None,) * 3))
                layer_drops = int(moe.DROPS[0][0])
                moe.DROPS = None
            out[tag] = dict(
                loss=np.array([float(ref), float(tot.full_tensor())]),
                aux=np.array([float(rm["aux_loss"]), float(m["aux_loss"].full_tensor())]),
                grad_err=np.array([float((a.full_tensor() - b).abs().max()
                                         / b.abs().max()) for a, b in zip(gs, rg)]),
                calls=np.array([calls["dense"], calls["shard_map"]]),
                drops=np.array(drops), layer_drops=np.array([layer_drops]),
                y=np.stack([y_dense.detach().numpy(),
                            y_cap.full_tensor().detach().numpy()]),
                layer_aux=np.array([float(aux_dense), float(aux_cap.full_tensor())]),
                x=x.numpy(), router=p_moe["router"].numpy())
        # remat "full" with the backward on another thread, as a CUDA
        # backward runs: the rerun layers must see the forward's mesh
        import threading
        cfg = smoke().scaled(compute_dtype="float32", remat="full",
                             capacity_factor=2.0)
        model = LanguageModel(cfg, device="cpu")
        params = model.init(0)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        ref, _ = model.train_loss(params, batch)
        rg = torch.autograd.grad(ref, leaves)
        with use_mesh_info(info):
            moe.PATH_CALLS.update(dense=0, shard_map=0)
            dp = distribute_tree(tree_map(lambda t: t.detach(), params),
                                 model.param_axes, info)
            dl = [p.requires_grad_(True) for p in tree_leaves(dp)]
            db = {k: info.distribute(v, ("batch", "seq_act"))
                  for k, v in batch.items()}
            tot, _ = model.train_loss(dp, db)
        got = {}
        worker = threading.Thread(
            target=lambda: got.update(g=torch.autograd.grad(tot, dl)))
        worker.start()
        worker.join()
        out["remat"] = dict(
            calls=np.array([moe.PATH_CALLS["dense"], moe.PATH_CALLS["shard_map"]]),
            grad_err=np.array([float((a.full_tensor() - b).abs().max()
                                     / b.abs().max()) for a, b in zip(got["g"], rg)]))
        for tag, arrays in out.items():
            emit(tag, **arrays)
    """, world=1, tmp_path=d)


def test_capacity_path_equals_dense_without_drops(capacity_one_rank):
    got = capacity_one_rank["full"]
    n_moe = sum(1 for t in granite().layer_types())
    assert got["calls"][0] == 0 and got["calls"][1] == n_moe, got["calls"]
    assert int(got["drops"].sum()) == 0
    np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["aux"][1], got["aux"][0], rtol=1e-5)
    assert got["grad_err"].max() < 1e-5, got["grad_err"]
    np.testing.assert_allclose(got["y"][1], got["y"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["layer_aux"][1], got["layer_aux"][0],
                               rtol=1e-5)


def test_remat_rerun_on_another_thread_keeps_the_mesh(capacity_one_rank):
    """Each MoE layer ran the capacity path in the forward and again in the
    rerun, though the backward ran on a thread without a mesh of its own."""
    got = capacity_one_rank["remat"]
    n_moe = sum(1 for _ in granite().layer_types())
    assert list(got["calls"]) == [0, 2 * n_moe], got["calls"]
    assert got["grad_err"].max() < 1e-5, got["grad_err"]


def _np_dropped(x2d, router, cfg):
    """Dropped (token, slot) assignments of one layer, counted in numpy:
    top-k experts per token from the router's softmax, then each
    assignment's place in its expert's buffer in (t, k) row-major order
    against the capacity."""
    logits = x2d.astype(np.float64) @ router.astype(np.float64)
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    cap = max(8, (int(len(x2d) * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts) + 7) // 8 * 8)
    seen = np.zeros(cfg.n_experts, np.int64)
    dropped = 0
    for e in idx.reshape(-1):
        dropped += seen[e] >= cap
        seen[e] += 1
    return dropped


def test_capacity_path_drop_count(capacity_one_rank):
    got = capacity_one_rank["drop"]
    cfg = granite().scaled(capacity_factor=1.25)
    x2d = got["x"].reshape(-1, cfg.d_model)
    assert int(got["layer_drops"][0]) == _np_dropped(x2d, got["router"], cfg)
    assert int(got["layer_drops"][0]) > 0  # the case exercises dropping
    assert len(got["drops"]) == sum(1 for _ in granite().layer_types())


@pytest.mark.parametrize("tokens", [1, 7, 8, 100, 513, 4096, 8192, 65536])
def test_capacity_matches_jax(tokens):
    for cf in (1.0, 1.25, 4.0):
        jcfg = jax_granite().scaled(capacity_factor=cf)
        tcfg = granite().scaled(capacity_factor=cf)
        assert moe._capacity(tokens, tcfg) == jax_moe._capacity(tokens, jcfg)
