"""The port's training path against the JAX package, on the CPU.

``LanguageModel.train_loss`` and every gradient leaf on bridged weights
(gemma-2b, deepseek-7b, rwkv6-1.6b, h2o-danube-1.8b, recurrentgemma-9b,
minicpm3-4b, granite-moe-1b-a400m and deepseek-v2-236b smoke configs in f32
compute: loss and the MoE router loss within 1e-5 relative, gradients within
2e-4 x max(1, max |g|), the decode-parity bound; RG-LRU's backward through
the doubling scan); the bf16 train cast leaf for leaf against JAX's
``_cast_for_compute``; remat and the per-layer weight views; five train
steps against JAX's jitted step (loss within 1e-4); and the driver,
mirroring ``tests/test_train_resume.py`` with ``device="cpu"``.
"""
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.launch.train import make_train_step, train  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import AdamW, OptConfig  # noqa: E402
from repro_torch.utils import tree_flatten, tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
ARCHS = ["gemma-2b", "deepseek-7b", "rwkv6-1.6b", "h2o-danube-1.8b",
         "recurrentgemma-9b", "minicpm3-4b"] + MOE_ARCHS
B, S = 2, 24
GRAD_TOL = 2e-4
#: bf16 compute: both packages round the same bf16 weights, but the
#: activations' bf16 roundings follow each backend's op order; on the smoke
#: configs that moves a loss of ~6 by 8e-4 (gemma-2b) and 1.4e-3 (rwkv6)
BF16_LOSS_TOL = 1e-2


def _name(arch):
    return arch.replace("-", "_").replace(".", "_")


def _configs(arch, compute="float32"):
    jcfg = importlib.import_module(f"repro.configs.{_name(arch)}").smoke()
    tcfg = importlib.import_module(f"repro_torch.configs.{_name(arch)}").smoke()
    return (jcfg.scaled(compute_dtype=compute),
            tcfg.scaled(compute_dtype=compute))


def _batch(vocab, step=0):
    """A TokenDataset batch with a few zero weights (the loss divides by the
    weights' sum)."""
    b = TokenDataset(vocab_size=vocab, seq_len=S, global_batch=B).batch(step)
    b["weights"][0, :5] = 0.0
    return b


def _moved(tree, seed=0):
    """Every leaf moved by 0.05 x a seeded normal (as the serving cast test
    does), so norm scales, w0, u ... sit off their init values; RG-LRU's
    ``conv_w``, which JAX inits to zeros, is drawn at 0.5 x a normal so the
    block's gates and scan carry weight."""
    rng = np.random.RandomState(seed)

    def move(path, a):
        if path[-1].key == "conv_w":
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(move, tree)


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, compute="float32"):
    """(numpy params, batch, JAX metrics, JAX grads) on moved seed-0 weights."""
    jcfg, _ = _configs(arch, compute)
    jm = JaxLM(jcfg)
    tree = _moved(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    batch = _batch(jcfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))
    (_, metrics), grads = fn(jax.tree.map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    return (tree, batch, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_loss(arch, compute="float32", **overrides):
    tree, batch, _, _ = _jax_reference(arch, compute)
    _, tcfg = _configs(arch, compute)
    model = LanguageModel(tcfg.scaled(**overrides), device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(tree, tcfg, "cpu"))
    total, metrics = model.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, params, total, metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(arch):
    _, _, jmetrics, _ = _jax_reference(arch)
    _, _, total, metrics = _port_loss(arch)
    assert set(metrics) == set(jmetrics) == {"loss", "aux_loss", "tokens",
                                             "total_loss"}
    np.testing.assert_allclose(metrics["loss"].item(), jmetrics["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(total.item(), jmetrics["total_loss"], rtol=1e-5)
    assert float(metrics["tokens"]) == jmetrics["tokens"] == B * S - 5
    if arch in MOE_ARCHS:  # the router loss, summed over the MoE layers
        assert jmetrics["aux_loss"] > 0
        np.testing.assert_allclose(metrics["aux_loss"].item(),
                                   jmetrics["aux_loss"], rtol=1e-5)
    else:
        assert float(metrics["aux_loss"]) == jmetrics["aux_loss"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_gradients_match_jax(arch):
    _, _, _, jgrads = _jax_reference(arch)
    _, params, total, _ = _port_loss(arch)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(total, leaves)
    ref = jax.tree.leaves(jgrads)
    assert len(grads) == len(ref)
    for (path, _), g, r in zip(tree_flatten(params), grads, ref):
        tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol,
                                   err_msg=f"{arch}: grad {path}")


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_bf16_train_cast_matches_jax_leaf_for_leaf(arch):
    """Trap 1: in training JAX casts every float leaf of stored rank >= 2
    to bf16 -- stacked norm scales, w0, u, decay_B too -- unlike serving.
    The port's train cast gives the same dtype at every leaf, and the bf16
    loss stays within ``BF16_LOSS_TOL`` of JAX's."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    tree, _, jmetrics, _ = _jax_reference(arch, "bfloat16")
    jcast = JaxLM(jcfg)._cast_for_compute(jax.tree.map(jnp.asarray, tree))
    model = LanguageModel(tcfg, device="cpu")
    cast = model.cast_for_train(params_from_numpy(tree, tcfg, "cpu"))
    ours = [(p, str(t.dtype).replace("torch.", "")) for p, t in tree_flatten(cast)]
    ref = [str(a.dtype) for a in jax.tree.leaves(jcast)]
    assert [d for _, d in ours] == ref, list(zip(ours, ref))
    if model.dec_segments[0].scanned:  # a stacked (L, d) vector
        assert dict(ours)["seg0/sub0/norm1/scale"] == "bfloat16"
    if arch == "rwkv6-1.6b":
        assert dict(ours)["seg0/sub0/core/u"] == "bfloat16"
    if arch == "recurrentgemma-9b":  # rounded in training, unlike serving
        assert dict(ours)["seg0/sub0/core/conv_w"] == "bfloat16"
        assert dict(ours)["seg0/sub0/core/lam"] == "float32"
    _, _, _, metrics = _port_loss(arch, "bfloat16")
    assert abs(metrics["loss"].item() - jmetrics["loss"]) < BF16_LOSS_TOL


def _count_superblocks(monkeypatch):
    calls = []
    real = tfm.apply_superblock

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfm, "apply_superblock", counting)
    return calls


class _CountDots(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matrix products run under it: ``plain`` without batch dims
    (``mm``, or ``bmm`` over a batch of 1, as an einsum over weights runs),
    ``batched`` the rest (attention's scores and weighted values)."""

    def __init__(self):
        super().__init__()
        self.plain = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default or (
                func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
            self.plain += 1
        elif func is torch.ops.aten.bmm.default:
            self.batched += 1
        return func(*args, **(kwargs or {}))


def test_remat_changes_no_gradient(monkeypatch):
    """``remat`` full, dots and none give bit-identical gradients on the CPU.
    Under ``full`` every layer of the scanned segment runs twice (forward and
    the backward's recompute); under ``dots`` it reruns too, but the outputs
    of its non-batched products are kept, so the backward reruns only the
    batched ones (attention's), as JAX's
    ``dots_with_no_batch_dims_saveable``."""
    out = {}
    for policy in ("none", "full", "dots"):
        calls = _count_superblocks(monkeypatch)
        model, params, total, _ = _port_loss("gemma-2b", remat=policy)
        seg = model.dec_segments[0]
        assert seg.scanned and seg.repeats == 2
        forward_calls = len(calls)
        with _CountDots() as dots:
            grads = torch.autograd.grad(total, tree_leaves(params))
        out[policy] = (grads, forward_calls, len(calls), dots.plain,
                       dots.batched)
    for policy in ("full", "dots"):
        for a, b in zip(out[policy][0], out["none"][0]):
            assert torch.equal(a, b), policy
    assert out["none"][1:3] == (2, 2)
    assert out["full"][1:3] == (2, 4)
    assert out["dots"][1:3] == (2, 4)
    assert out["full"][3] > out["none"][3] and out["full"][4] > out["none"][4]
    assert out["dots"][3] == out["none"][3]
    assert out["dots"][4] == out["full"][4]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_keeps_router_loss_gradient(arch):
    """The router loss leaves each checkpointed layer beside x: under
    ``remat`` full and dots the total loss and every gradient equal the
    unchecked run's bit for bit, and the routers' gradients, which the aux
    loss feeds, are not zero."""
    runs = {}
    for policy in ("none", "full", "dots"):
        model, params, total, metrics = _port_loss(arch, remat=policy)
        assert any(seg.scanned for seg in model.dec_segments)
        grads = torch.autograd.grad(total, tree_leaves(params))
        runs[policy] = (total, metrics["aux_loss"], grads)
        routers = [g for (path, _), g in zip(tree_flatten(params), grads)
                   if path.endswith("router")]
        assert routers and all(float(g.abs().max()) > 0 for g in routers)
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        assert torch.equal(runs[policy][1], runs["none"][1])
        for a, b in zip(runs[policy][2], runs["none"][2]):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_scanned_weights_have_no_per_layer_select_backward(arch, compute):
    """Each stacked weight reaches the layers through one ``unbind`` (whose
    backward is a single stack), never a per-layer ``t[i]`` select (whose
    backward is a zero tensor the size of the whole stack per layer)."""
    model, params, total, _ = _port_loss(arch, compute)
    stacked = {id(t) for k, seg in params.items() if k.startswith("seg")
               for t in tree_leaves(seg)}
    users: dict[int, list] = {}
    seen, stack, keep = set(), [total.grad_fn], []
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        keep.append(node)
        for child, _ in node.next_functions:
            if child is not None:
                users.setdefault(id(child), []).append(node)
                stack.append(child)
    found = 0
    for node in keep:
        var = getattr(node, "variable", None)
        if var is None or id(var) not in stacked:
            continue
        found += 1
        consumers = users[id(node)]
        while all(c.name() == "ToCopyBackward0" for c in consumers):
            consumers = [u for c in consumers for u in users[id(c)]]
        assert [c.name() for c in consumers] == ["UnbindBackward0"], \
            [c.name() for c in consumers]
    assert found == len(stacked)


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "minicpm3-4b",
                                  *MOE_ARCHS])
def test_five_train_steps_match_jax(arch):
    """The port's eager step against JAX's jitted step (``make_train_step``
    of both packages) on bridged weights and the same batches, f32."""
    jcfg, tcfg = _configs(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=10)
    jstep = jax_make_train_step(JaxLM(jcfg), JaxAdamW(JaxOptConfig(**kw)))
    opt = AdamW(OptConfig(**kw))
    step = make_train_step(LanguageModel(tcfg, device="cpu"), opt)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = JaxAdamW(JaxOptConfig(**kw)).init(jparams)
    params = params_from_numpy(tree, tcfg, "cpu")
    state = opt.init(params)
    data = TokenDataset(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=2)
    for i in range(5):
        batch = data.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-4, i
        assert set(m) == set(jm)


def test_train_step_launches_no_kernel():
    """Training reaches neither hand-written kernel (neither has a backward,
    in JAX or here): the flash and WKV launch counts stay put, and on the
    CPU the wrappers are not called at all."""
    before = fa.launches, ls.launches
    out = train(arch="rwkv6-1.6b", steps=2, global_batch=2, seq_len=16,
                log_every=1, device="cpu")
    out = train(arch="gemma-2b", steps=2, global_batch=2, seq_len=16,
                log_every=1, device="cpu")
    assert out["steps"] == 2
    assert (fa.launches, ls.launches) == before


# ------------------------------------- tests/test_train_resume.py, mirrored


def test_loss_decreases_smoke():
    out = train(arch="gemma-2b", smoke=True, steps=30, global_batch=4,
                seq_len=64, peak_lr=5e-3, log_every=5, ckpt_dir=None,
                device="cpu")
    assert out["first_loss"] is not None
    assert out["final_loss"] < out["first_loss"] - 0.3, out["history"]


def test_preemption_resume_equivalence(tmp_path):
    """train 12 steps straight == train 8, preempt, resume to 12 (same data,
    same seeds): the checkpoint carries the full optimizer state."""
    kw = dict(arch="h2o-danube-1.8b", smoke=True, steps=12, global_batch=2,
              seq_len=32, save_every=4, log_every=12, device="cpu")
    ref = train(ckpt_dir=str(tmp_path / "straight"), **kw)
    d2 = str(tmp_path / "resumed")
    with pytest.raises(SystemExit) as e:
        train(ckpt_dir=d2, preempt_at=8, **kw)
    assert e.value.code == 17
    res = train(ckpt_dir=d2, resume=True, **kw)
    assert abs(res["final_loss"] - ref["final_loss"]) < 1e-3, \
        (res["final_loss"], ref["final_loss"])


def test_cli_driver_runs(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", "rwkv6-1.6b", "--steps", "4", "--batch", "2", "--seq",
           "32", "--log-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=400,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done:" in r.stdout
    assert (tmp_path / "ck" / "step_00000004" / "COMMITTED").exists()
