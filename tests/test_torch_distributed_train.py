"""Training under a mesh: the port's sharded runs on gloo ranks against its
own single-process runs and the JAX package's single-device ones (JAX's
multi-device tests do not run under this jax; these hold the port to the
claims they make: sharded equals unsharded, ``rtol 2e-4``,
``tests/test_multidevice.py:68, 101``, and a shrunk-and-restored
trajectory equals a straight run, ``2e-3``,
``tests/test_elastic_remesh.py:136``).

* MoE: deepseek-v2 smoke (``n_experts=8``, ``d_model=64``, ``_SMALL_T``
  16), f32, B 4 x S 32 on a 2 x 2 mesh, through ``_moe_shard_map``
  (asserted): the loss against the port's unsharded loss and JAX's, ``rtol
  2e-4``; then, with ``capacity_factor = E / top_k`` (nothing dropped), the
  gradients of the next-token loss against the unsharded ones, 1e-4 of
  max |g|, and those of the total loss against an unsharded model whose
  router loss is, as on the mesh (JAX's ``pmean``), the mean of each
  shard's own.
* GQA: qwen2-vl smoke, B 4 x S 64, on 2 x 2 and on 1 x 4 (one head a
  rank): loss and every gradient; the same for recurrentgemma smoke (RG-LRU
  and sliding-window MQA), B 4 x S 32, for rwkv6 smoke on 2 x 2 and 1 x 4
  and for whisper-medium smoke (with frames) on 2 x 2.
* ``_shard_aligned_attention``: gemma-2b smoke with 6 heads (not a multiple
  of the model axis) on a 1 x 4 mesh, B 2 x S 2048, remat ``"full"``, the
  score budget lowered so each device loops over row chunks: loss and every
  gradient.
* Elastic: gemma-2b smoke, f32: 4 steps on 2 x 2, save, restore with
  ``sharding_fn`` onto 2 x 1, 2 more steps: the last two losses against
  JAX's straight 6-step run (2e-3) and the port's single-process run
  (1e-5); and ``train(mesh_info=...)`` preempted and resumed across the same
  two meshes against a single-process ``train``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import TokenDataset as JaxTokenDataset  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402

#: the child's side of the parity cases in ``DIR/cases.json``: per case,
#: the bridged weights and batch through ``sharded_vs_unsharded`` on the
#: case's mesh; emits its arrays and the shard-aligned row blocks run
PARITY = """
from repro_torch.bridge import params_from_numpy
from repro_torch.models import LanguageModel, attention, moe
import importlib, json

blocks = [0]
inner = attention._attn_block_tp
def counted(*a, **k):
    blocks[0] += 1
    return inner(*a, **k)
attention._attn_block_tp = counted
dense = moe._moe_dense

def shard_router_loss(n_data, n_model):
    # _moe_dense with the capacity path's router loss: _route on each
    # (data, model) shard's own tokens, their losses averaged as pmean does
    def f(p, cfg, x):
        y, _ = dense(p, cfg, x)
        d = x.shape[-1]
        aux = [moe._route(p["router"], s.reshape(-1, d), cfg)[2]
               for rows in x.chunk(n_data, 0) for s in rows.chunk(n_model, 1)]
        return y, torch.stack(aux).mean()
    return f

defaults = {"moe._SMALL_T": moe._SMALL_T,
            "attention._SCORE_BYTES_BUDGET": attention._SCORE_BYTES_BUDGET}
for name, spec in json.load(open(os.path.join(DIR, "cases.json"))).items():
    case = os.path.join(DIR, name)
    cfg = importlib.import_module("repro_torch.configs." + spec["module"]).smoke()
    cfg = cfg.scaled(**spec["cfg"])
    for k, v in {**defaults, **spec.get("patch", {})}.items():
        mod, attr = k.split(".")
        setattr({"moe": moe, "attention": attention}[mod], attr, v)
    z = np.load(os.path.join(case, "params.npz"))
    tree = {}
    for key in z.files:
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    params = params_from_numpy(tree, cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(os.path.join(case, "batch.npz")).items()}
    model = LanguageModel(cfg, device="cpu")
    info = small_mesh_info(tuple(spec["mesh"]), device_type="cpu")
    if spec.get("shard_router_loss"):  # the unsharded run's only: off the mesh
        moe._moe_dense = shard_router_loss(*spec["mesh"])
    blocks[0] = 0
    try:
        got = sharded_vs_unsharded(
            model, params, batch, info, spec.get("grad_of", "total_loss"),
            layouts={k: tuple(v) for k, v in spec.get("layouts", {}).items()})
    finally:
        moe._moe_dense = dense
    emit(name, blocks=np.array(blocks), **got)
"""


def _save_params(d, params):
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(d / "params.npz", **flat)


def _write_case(d, arch, cfg_kw, B, S, mesh, seed=0, **extra):
    """JAX's weights (``PRNGKey(seed)``) and a batch to ``d``; returns the
    case's spec and JAX's single-device loss."""
    mod = arch.replace("-", "_").replace(".", "_")
    jcfg = importlib.import_module(f"repro.configs.{mod}").smoke().scaled(**cfg_kw)
    model = JaxLM(jcfg)
    params = model.init(jax.random.PRNGKey(seed))
    d.mkdir()
    _save_params(d, params)
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "weights": np.ones((B, S), np.float32)}
    if jcfg.enc_dec:  # the encoder's frames, S of them a row
        batch["frames"] = rng.standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32)
    np.savez(d / "batch.npz", **batch)
    loss, _ = jax.jit(model.train_loss)(params, {k: jnp.asarray(v)
                                                 for k, v in batch.items()})
    return {"module": mod, "cfg": cfg_kw, "mesh": mesh, **extra}, float(loss)


MOE = dict(compute_dtype="float32", n_experts=8, d_model=64)
N_MOE = 2  # deepseek-v2 smoke: one dense layer, then two MoE layers
#: 6 heads on a 4-way model axis: q is sequence-sharded and each device runs
#: its 512 rows in chunks of 64 (the score budget lowered to 64 rows' worth:
#: B_loc 2 x 6 heads x 2048 keys x 4 bytes a row)
ALIGNED_BUDGET = 64 * 2 * 6 * 2048 * 4


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every parity case in one run of 4 gloo ranks: ``{case: (port's
    results, JAX's single-device loss)}``."""
    import json

    d = tmp_path_factory.mktemp("parity")
    cases = {
        # JAX's setup (test_multidevice.py:32-71): default capacity factor
        "moe": ("deepseek-v2-236b", MOE, 4, 32, [2, 2], 0,
                {"patch": {"moe._SMALL_T": 16}}),
        # E / top_k: cap >= T, nothing dropped; the next-token loss's grads
        "moe_grad": ("deepseek-v2-236b", {**MOE, "capacity_factor": 8 / 2}, 4,
                     32, [2, 2], 0,
                     {"patch": {"moe._SMALL_T": 16}, "grad_of": "loss"}),
        # the total loss, router loss included, against the unsharded model
        # whose router loss is the mean of each shard's
        "moe_router": ("deepseek-v2-236b", {**MOE, "capacity_factor": 8 / 2},
                       4, 32, [2, 2], 0, {"patch": {"moe._SMALL_T": 16},
                                          "shard_router_loss": True}),
        "gqa": ("qwen2-vl-72b", dict(compute_dtype="float32"), 4, 64, [2, 2],
                1, {}),
        "rglru": ("recurrentgemma-9b", dict(compute_dtype="float32"), 4, 32,
                  [2, 2], 3, {}),
        # 4 heads over a 4-way model axis, 2 KV heads: one head a rank
        "gqa_1x4": ("qwen2-vl-72b", dict(compute_dtype="float32"), 4, 64,
                    [1, 4], 4, {}),
        "aligned": ("gemma-2b", dict(compute_dtype="float32", n_heads=6,
                                     remat="full"), 2, 2048, [1, 4], 2,
                    {"patch": {"attention._SCORE_BYTES_BUDGET": ALIGNED_BUDGET}}),
        # RWKV-6: the chunked WKV form on each rank's (batch, heads) shard
        "rwkv_2x2": ("rwkv6-1.6b", dict(compute_dtype="float32"), 4, 32,
                     [2, 2], 5, {}),
        "rwkv_1x4": ("rwkv6-1.6b", dict(compute_dtype="float32"), 4, 32,
                     [1, 4], 6, {}),
        # frames laid out as JAX's specs.py:34-36
        "whisper": ("whisper-medium", dict(compute_dtype="float32"), 4, 32,
                    [2, 2], 7, {"layouts": {"frames": ["batch", "seq_act",
                                                       None]}}),
    }
    specs, jax_losses = {}, {}
    for name, (arch, kw, B, S, mesh, seed, extra) in cases.items():
        specs[name], jax_losses[name] = _write_case(d / name, arch, kw, B, S,
                                                    mesh, seed, **extra)
    (d / "cases.json").write_text(json.dumps(specs))
    got = run_ranks(PARITY, world=4, tmp_path=d)
    return {name: (got[name], jax_losses[name]) for name in cases}


def test_sharded_loss_moe(parity):
    got, jax_loss = parity["moe"]
    assert list(got["calls"]) == [0, N_MOE], got["calls"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    np.testing.assert_allclose(unsharded, jax_loss, rtol=1e-5)


def test_sharded_grads_moe(parity):
    got, _ = parity["moe_grad"]
    assert list(got["calls"]) == [0, N_MOE], got["calls"]
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_sharded_router_grads_moe(parity):
    """The router loss's gradients through ``pmean`` and ``shard_map``'s
    ``Partial`` rule: every gradient of the total loss on 2 x 2 against the
    unsharded model's, whose router loss is the mean of ``_route``'s loss on
    each (data, model) shard's tokens."""
    got, _ = parity["moe_router"]
    assert list(got["calls"]) == [0, N_MOE], got["calls"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_sharded_loss_gqa(parity):
    got, jax_loss = parity["gqa"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_sharded_loss_gqa_one_head_a_rank(parity):
    """Heads split one a rank: the (Hkv, G) regrouping of q, which cannot
    keep that sharding, happens only on the shard-aligned path."""
    got, jax_loss = parity["gqa_1x4"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_sharded_loss_rglru(parity):
    """RG-LRU layers (their doubling scan) and sliding-window MQA."""
    got, jax_loss = parity["rglru"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


@pytest.mark.parametrize("case", ["rwkv_2x2", "rwkv_1x4"])
def test_sharded_loss_rwkv6(parity, case):
    """RWKV-6 under a mesh (ROADMAP §3, fault 4): the token-shift mixes with
    their (5, lora) dims whole, r/k/v/log_w split over heads, the initial
    state lifted onto the mesh, the WKV scan on each rank's own (batch,
    heads) shard; heads two a rank on 2 x 2, one on 1 x 4."""
    got, jax_loss = parity[case]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_sharded_loss_whisper(parity):
    """whisper-medium on 2 x 2: frames laid out ``("batch", "seq_act",
    None)``, the encoder, cross-attention, learned decoder positions and
    LayerNorm under the mesh."""
    got, jax_loss = parity["whisper"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_shard_aligned_attention(parity):
    got, jax_loss = parity["aligned"]
    # two layers, 8 row chunks each; remat "full" reruns each layer's chunks
    assert got["blocks"][0] == 2 * 8 * 2, got["blocks"]
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    np.testing.assert_allclose(sharded, jax_loss, rtol=2e-4)
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


ELASTIC = """
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.gemma_2b import smoke
from repro_torch.data import TokenDataset
from repro_torch.distributed.sharding import distribute_tree, use_mesh_info
from repro_torch.launch.train import make_train_step, opt_state_shardings, train
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW, OptConfig

cfg = smoke().scaled(compute_dtype="float32")
model = LanguageModel(cfg, device="cpu")
z = np.load(os.path.join(DIR, "params.npz"))
tree = {}
for key in z.files:
    node = tree
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = z[key]
init = lambda: params_from_numpy(tree, cfg, device="cpu")  # JAX's weights
opt = AdamW(OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=20))
data = TokenDataset(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
step_fn = make_train_step(model, opt)
mgr = CheckpointManager(os.path.join(DIR, "ck"), async_write=False)
PHASE = os.environ["PHASE"]

def run(params, state, start, n, info=None):
    losses = []
    for s in range(start, start + n):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        if info is not None:
            batch = {k: info.distribute(v, ("batch", "seq_act")) for k, v in batch.items()}
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    return params, state, losses

# train(): 3 steps on 2 x 2 saved, resumed on 2 x 1 to step 5
run_kw = dict(arch="gemma-2b", steps=3, global_batch=4, seq_len=32,
              ckpt_dir=os.path.join(DIR, "ck_train"), save_every=3,
              log_every=1, device="cpu")
if PHASE == "big":
    info = small_mesh_info((2, 2), device_type="cpu")
    with use_mesh_info(info):
        params = distribute_tree(init(), model.param_axes, info)
        params, state, _ = run(params, opt.init(params), 0, 4, info)
        mgr.save(4, {"params": params, "opt_state": state})
        mgr.wait()
    train(mesh_info=info, **run_kw)
else:
    params = init()  # the port's straight single-process run
    _, _, straight = run(params, opt.init(params), 0, 6)
    run_kw["steps"] = 5
    resumed = train(mesh_info=small_mesh_info((2, 1), device_type="cpu"),
                    **run_kw)
    assert resumed["checkpoint"]["resumed_step"] == 3
    one = train(**{**run_kw, "ckpt_dir": None})

    info = small_mesh_info((2, 1), device_type="cpu")
    with use_mesh_info(info):
        like = distribute_tree(init(), model.param_axes, info)
        like_state = opt.init(like)
        step, tree = mgr.restore_latest({"params": like, "opt_state": like_state},
                                        device="cpu",
                                        sharding_fn=opt_state_shardings(like))
        assert step == 4
        p0 = tree["params"]["seg0"]["sub0"]["mlp"]["w_up"]
        assert list(p0.placements) == list(like["seg0"]["sub0"]["mlp"]["w_up"].placements)
        _, _, losses = run(tree["params"], tree["opt_state"], step, 2, info)
    emit("small", losses=np.array(losses), straight=np.array(straight),
         resumed=np.array([[h["loss"] for h in r["history"][-2:]]
                          for r in (resumed, one)]))
"""


def _jax_straight(d):
    """JAX's straight 6-step run; its initial weights go to ``d``."""
    from repro.configs.gemma_2b import smoke

    cfg = smoke().scaled(compute_dtype="float32")
    model = JaxLM(cfg)
    opt = JaxAdamW(JaxOptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=20))
    data = JaxTokenDataset(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)

    @jax.jit
    def f(params, state, batch):
        (_, m), g = jax.value_and_grad(model.train_loss, has_aux=True)(params, batch)
        p2, s2, _ = opt.update(g, state, params)
        return p2, s2, m["loss"]

    params = model.init(jax.random.PRNGKey(0))
    _save_params(d, params)
    state = opt.init(params)
    losses = []
    for s in range(6):
        batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, state, loss = f(params, state, batch)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    ref = _jax_straight(d)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PHASE", "big")
        run_ranks(ELASTIC, world=4, tmp_path=d)
        mp.setenv("PHASE", "small")
        small = run_ranks(ELASTIC, world=2, tmp_path=d)["small"]
    finally:
        mp.undo()
    return {**small, "jax": np.array(ref)}


def test_elastic_shrink_matches_straight_run(elastic):
    got, port, ref = elastic["losses"], elastic["straight"], elastic["jax"]
    np.testing.assert_allclose(got, port[-2:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref[-2:], rtol=0, atol=2e-3)
    # the JAX package's own check, on the port's single-process run too
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-3)


def test_train_resumes_on_a_smaller_mesh(elastic):
    """``train(mesh_info=...)``: 3 steps on 2 x 2, preempted, resumed onto
    2 x 1 to step 5, against a single-process ``train``'s steps 4 and 5
    (gemma-2b smoke in its bf16 compute: the sharded reductions round
    differently, ``BF16_LOSS_TOL`` of ``tests/test_torch_train.py``)."""
    resumed, one = elastic["resumed"]
    np.testing.assert_allclose(resumed, one, rtol=0, atol=1e-2)
