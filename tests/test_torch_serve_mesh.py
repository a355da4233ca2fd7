"""Serving under a mesh (ROADMAP §3, fault 5): ``prefill``,
``prefill_chunk`` and ``decode_step`` of the port on gloo ranks against its
own unsharded run and, for five archs, against the JAX package's
single-device run (``tests/test_decode_parity.py``'s limits: 2e-4 on the
prefill logits, 3e-4 on each decode step, f32).

* Every arch of ``test_decode_parity.py`` at smoke width, JAX's weights
  (``PRNGKey(0)``; RG-LRU's zero-init ``conv_w`` drawn at 0.5 x a seeded
  normal), B 4 x S 32 seeded with numpy, then 4 decode steps of given
  tokens, on the (data, model) meshes (2, 2) and (1, 4): one launch of four
  ranks a mesh, both meshes at once, each looping over the archs through
  ``_torch_dist.serve_sharded_vs_unsharded`` (under ``no_strided_views``).
  A second run a arch prefills 24 tokens and continues with an 8-token
  ``prefill_chunk``.  qwen2-vl-72b (2 KV heads) runs once more on (1, 4)
  with a 50-slot cache, which the model axis does not divide.  The kernel
  wrappers are called on each rank's plain local shards: flash once a full prefill per attention layer (whisper:
  encoder, self and cross), the WKV scan once a prefill or chunk per RWKV-6
  layer.
* A fake 2 x 2 ``run_cell`` of prefill and decode for every arch, in a
  child (the fake process group is global): ``status: ok``, argument bytes
  a rank equal to those worked out from ``param_axes``, the cache specs'
  axes and the mesh shape alone.
* The wrappers refuse a DTensor (``TypeError``) on a one-rank gloo mesh;
  the same call on its local tensors equals the plain version.
"""
import concurrent.futures as cf
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import LanguageModel as JaxLM  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [
    "whisper-medium", "h2o-danube-1.8b", "gemma-2b", "minicpm3-4b",
    "deepseek-7b", "recurrentgemma-9b", "deepseek-v2-236b",
    "granite-moe-1b-a400m", "qwen2-vl-72b", "rwkv6-1.6b",
]
JAX_ARCHS = ("gemma-2b", "minicpm3-4b", "recurrentgemma-9b", "rwkv6-1.6b",
             "whisper-medium")
MESHES = [(2, 2), (1, 4)]
B, S, STEPS, CHUNK, MAX_LEN = 4, 32, 4, 8, 48
#: a GQA arch (2 KV heads, 4 q heads) served on (1, 4) once more with a
#: cache of ODD_LEN slots, which the model axis does not divide: the cache
#: is whole on every rank while q is split on ``heads``
ODD_ARCH, ODD_MESH, ODD_LEN = "qwen2-vl-72b", (1, 4), 50
PREFILL_TOL, DECODE_TOL = 2e-4, 3e-4


def _module(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


#: the children: each arch's JAX weights and inputs from ``DIR/<arch>``,
#: served unsharded and on ``MESH``, with and without a chunked prefill
SERVE = """
import importlib, json
from _torch_dist import serve_sharded_vs_unsharded
from repro_torch.bridge import params_from_numpy

info = small_mesh_info(MESH, device_type="cpu")
for arch in json.load(open(os.path.join(DIR, "archs.json"))):
    case = os.path.join(DIR, arch)
    mod = arch.replace("-", "_").replace(".", "_")
    cfg = importlib.import_module("repro_torch.configs." + mod).smoke()
    cfg = cfg.scaled(compute_dtype="float32")
    z = np.load(os.path.join(case, "params.npz"))
    tree = {}
    for key in z.files:
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    from repro_torch.models import LanguageModel
    model = LanguageModel(cfg, device="cpu")
    params = params_from_numpy(tree, cfg, device="cpu")
    inputs = dict(np.load(os.path.join(case, "inputs.npz")))
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    layouts = {}
    if "frames" in inputs:  # laid out as JAX's specs.py:34-36
        batch["frames"] = torch.from_numpy(inputs["frames"])
        layouts["frames"] = ("batch", "seq_act", None)
    follow = torch.from_numpy(inputs["follow"])
    full = serve_sharded_vs_unsharded(model, params, batch, info, follow,
                                      MAX_LEN, layouts)
    chunked = serve_sharded_vs_unsharded(model, params, batch, info, follow,
                                         MAX_LEN, layouts, chunk=CHUNK)
    odd = {}
    if arch == ODD_ARCH and MESH == ODD_MESH:
        odd = serve_sharded_vs_unsharded(model, params, batch, info, follow,
                                         ODD_LEN, layouts)
    emit(arch, **full, **{"chunk_" + k: v for k, v in chunked.items()},
         **{"odd_" + k: v for k, v in odd.items()})
"""


def _save_params(d: Path, params) -> None:
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(d / "params.npz", **flat)


def _draw_conv(params, seed: int):
    """RG-LRU's ``conv_w`` at 0.5 x a seeded normal: JAX's zero init would
    zero every RG-LRU output and state."""
    rng = np.random.RandomState(seed)

    def move(path, a):
        if path[-1].key == "conv_w":
            return jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


def _jax_serve(model, params, batch, follow) -> np.ndarray:
    """JAX's single-device prefill logits, then each decode step's:
    (1 + STEPS, B, vocab)."""
    cache = model.init_cache(B, max_len=MAX_LEN, enc_len=S, dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(params, batch, cache)
    out = [np.asarray(logits)]
    step = jax.jit(model.decode_step)
    for t in range(STEPS):
        logits, cache = step(params, jnp.asarray(follow[:, t:t + 1]), cache,
                             jnp.full((B,), S + t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


#: every arch's prefill and decode cell at smoke width on a fake 2 x 2 mesh,
#: in one process: (arch, kind, status, argument bytes a rank)
CELLS = """
import importlib, json, sys
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import run_cell
out = []
for arch in json.loads(sys.argv[1]):
    mod = arch.replace("-", "_").replace(".", "_")
    cfg = importlib.import_module("repro_torch.configs." + mod).smoke()
    for kind in ("prefill", "decode"):
        c = run_cell(arch, "smoke_" + kind, "32x8", cfg=cfg,
                     shape=ShapeSpec("smoke_" + kind, kind, %d, %d),
                     layout=((2, 2), ("data", "model")))
        out.append([arch, kind, c["status"],
                    c.get("memory_analysis", {}).get("argument_size_in_bytes"),
                    c.get("traceback", "")[-1500:]])
print(json.dumps(out))
""" % (S, B)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``{mesh: {arch: the children's arrays}}``, JAX's reference logits
    ``{arch: (1 + STEPS, B, vocab)}`` and the fake cells' records, from
    two rank launches and one child running together."""
    root = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = subprocess.Popen([sys.executable, "-c", CELLS, json.dumps(ARCHS)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=ROOT)
    ref = {}
    for i, arch in enumerate(ARCHS):
        jcfg = importlib.import_module(
            f"repro.configs.{_module(arch)}").smoke().scaled(
                compute_dtype="float32")
        model = JaxLM(jcfg)
        params = _draw_conv(model.init(jax.random.PRNGKey(0)), i)
        rng = np.random.RandomState(i)
        inputs = {"tokens": rng.randint(0, jcfg.vocab_size, (B, S)),
                  "follow": rng.randint(0, jcfg.vocab_size, (B, STEPS))}
        if jcfg.enc_dec:
            inputs["frames"] = rng.standard_normal(
                (B, S, jcfg.d_model)).astype(np.float32)
        inputs["tokens"] = inputs["tokens"].astype(np.int32)
        inputs["follow"] = inputs["follow"].astype(np.int32)
        for mesh in MESHES:
            d = root / f"{mesh[0]}x{mesh[1]}" / arch
            d.mkdir(parents=True)
            _save_params(d, params)
            np.savez(d / "inputs.npz", **inputs)
        if arch in JAX_ARCHS:
            batch = {k: jnp.asarray(v) for k, v in inputs.items()
                     if k != "follow"}
            ref[arch] = _jax_serve(model, params, batch, inputs["follow"])
    def launch(mesh):
        d = root / f"{mesh[0]}x{mesh[1]}"
        (d / "archs.json").write_text(json.dumps(ARCHS))
        body = (f"MESH = {mesh!r}\nMAX_LEN = {MAX_LEN}\nCHUNK = {CHUNK}\n"
                f"ODD_ARCH = {ODD_ARCH!r}\nODD_MESH = {ODD_MESH!r}\n"
                f"ODD_LEN = {ODD_LEN}\n" + SERVE)
        return run_ranks(body, world=4, tmp_path=d, timeout=600)

    with cf.ThreadPoolExecutor(len(MESHES)) as ex:
        runs = dict(zip(MESHES, ex.map(launch, MESHES)))
    out, err = cells.communicate(timeout=600)
    assert cells.returncode == 0, err[-3000:]
    records = json.loads(out.strip().splitlines()[-1])
    return runs, ref, records


CASES = [pytest.param(mesh, arch, id=f"{mesh[0]}x{mesh[1]}-{arch}")
         for mesh in MESHES for arch in ARCHS]


def _close(got, want, what):
    np.testing.assert_allclose(got[0], want[0], rtol=PREFILL_TOL,
                               atol=PREFILL_TOL, err_msg=f"{what}: prefill")
    for t in range(1, len(want)):
        np.testing.assert_allclose(got[t], want[t], rtol=DECODE_TOL,
                                   atol=DECODE_TOL,
                                   err_msg=f"{what}: decode step {t}")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_serve_on_mesh_matches_unsharded(served, mesh, arch):
    """Prefill and every decode step, and the chunked run (prefill of 24,
    a chunk of 8, then the decode steps), on the mesh against the
    unsharded port."""
    got = served[0][mesh][arch]
    unsharded, sharded = got["logits"]
    assert sharded.shape == (1 + STEPS, B, unsharded.shape[-1])
    _close(sharded, unsharded, f"{arch} on {mesh}")
    unsharded, sharded = got["chunk_logits"]
    assert sharded.shape[0] == 2 + STEPS
    _close(sharded, unsharded, f"{arch} on {mesh}, chunked")


def test_serve_on_mesh_cache_slots_off_the_model_axis(served):
    """ODD_ARCH on ODD_MESH with ODD_LEN cache slots: each rank's q heads
    read their own KV heads of the whole cache, as the unsharded run does,
    and the longer cache leaves the unsharded logits as they were."""
    got = served[0][ODD_MESH][ODD_ARCH]
    unsharded, sharded = got["odd_logits"]
    assert sharded.shape == (1 + STEPS, B, unsharded.shape[-1])
    _close(sharded, unsharded, f"{ODD_ARCH} on {ODD_MESH}, {ODD_LEN} slots")
    _close(unsharded, got["logits"][0], f"{ODD_ARCH}, {ODD_LEN} slots")
    assert bool(got["odd_local"])


@pytest.mark.parametrize("mesh,arch", [c for c in CASES
                                       if c.values[1] in JAX_ARCHS])
def test_serve_on_mesh_matches_jax(served, mesh, arch):
    """The mesh run against JAX's single-device prefill and decode, and the
    unsharded port against it too."""
    unsharded, sharded = served[0][mesh][arch]["logits"]
    _close(sharded, served[1][arch], f"{arch} on {mesh} against JAX")
    _close(unsharded, served[1][arch], f"{arch} unsharded against JAX")


def _per_prefill(arch: str) -> tuple[int, int]:
    """(flash, WKV) wrapper calls of one full prefill: one a layer that
    attends (an encoder-decoder's encoder, self and cross layers), one a
    layer that scans."""
    cfg = importlib.import_module(
        f"repro_torch.configs.{_module(arch)}").smoke()
    types = cfg.layer_types()
    if cfg.enc_dec:
        return cfg.n_enc_layers + 2 * cfg.n_layers, 0
    return (sum(t in ("attn", "swa") for t in types),
            sum(t == "rwkv6" for t in types))


@pytest.mark.parametrize("mesh,arch", CASES)
def test_serve_on_mesh_calls_kernels_on_local_shards(served, mesh, arch):
    """Under the mesh the wrappers see plain local tensors (a DTensor would
    raise), flash once a full prefill per attention layer and the WKV scan
    in the prefill and the chunk; the CPU takes the plain versions, so no
    kernel launches here."""
    got = served[0][mesh][arch]
    flash, wkv = _per_prefill(arch)
    assert list(got["calls"]) == [flash, wkv]
    assert list(got["chunk_calls"]) == [flash, 2 * wkv]
    assert bool(got["local"]) and bool(got["chunk_local"])
    assert list(got["launches"]) == [0, 0]


def _expected_bytes(arch: str, kind: str) -> int:
    """Per-rank bytes of the bf16 serving weights, the cache and the step's
    inputs, from ``param_axes``, the cache specs' axes (taken under a 2 x 2
    layout) and the rules alone: each dim divided by the mesh axes that
    split it."""
    from repro_torch.distributed.sharding import (DEFAULT_RULES, MeshInfo,
                                                  use_mesh_info)
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_flatten

    sizes = {"data": 2, "model": 2}

    def local(shape, axes):
        n, used = 1, set()
        for dim, name in zip(shape, axes):
            split = 1
            for ax in DEFAULT_RULES.get(name, ()):
                if ax in sizes and ax not in used and \
                        dim % (split * sizes[ax]) == 0:
                    split *= sizes[ax]
                    used.add(ax)
            n *= dim // split
        return n

    cfg = importlib.import_module(
        f"repro_torch.configs.{_module(arch)}").smoke().scaled(
            param_dtype="bfloat16")
    model = LanguageModel(cfg, device="meta")
    axes = dict(tree_flatten(model.param_axes))
    total = sum(local(t.shape, axes[k]) * t.element_size()
                for k, t in tree_flatten(model.init()))
    layout = MeshInfo(SimpleNamespace(axis_names=("data", "model"),
                                      devices=np.empty((2, 2))))
    with use_mesh_info(layout):
        specs = model.cache_specs(B, S, enc_len=S, dtype=torch.bfloat16)
    for _, sp in tree_flatten(specs):
        total += local(sp.shape, sp.axes) * sp.dtype.itemsize
    if kind == "decode":  # tokens (B, 1) and positions (B,), int32
        return total + 4 * (local((B, 1), ("batch", None))
                            + local((B,), ("batch",)))
    total += 4 * local((B, S), ("batch", "seq_act"))
    if cfg.enc_dec:
        total += 4 * local((B, S, cfg.d_model), ("batch", "seq_act", None))
    if cfg.pos_type == "mrope":
        total += 4 * local((3, B, S), (None, "batch", "seq_act"))
    return total


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_on_a_fake_mesh(served, arch, kind):
    rec = {(a, k): (status, nbytes, tb)
           for a, k, status, nbytes, tb in served[2]}
    status, nbytes, tb = rec[(arch, kind)]
    assert status == "ok", tb
    assert nbytes == _expected_bytes(arch, kind)


REFUSAL = """
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.ref import attention_ref
from repro_torch.kernels.linear_scan import linear_scan_plain

info = small_mesh_info((1, 1), device_type="cpu")
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(2, 16, 4, 32, generator=g) for _ in range(3))
r, kk, vv = (torch.randn(2, 16, 2, 64, generator=g) for _ in range(3))
log_w = -torch.rand(2, 16, 2, 64, generator=g)
u = torch.randn(2, 64, generator=g)
s0 = torch.randn(2, 2, 64, 64, generator=g)
dq, dk, dv = (info.distribute(t, ("batch", None, "heads", None))
              for t in (q, k, v))
wkv = [info.distribute(t, ("batch", None, "rwkv_heads", None))
       for t in (r, kk, vv, log_w)]
du = info.distribute(u, ("rwkv_heads", None))
ds0 = info.distribute(s0, ("batch", "rwkv_heads", None, None))
refused = []
for call in (lambda: flash_attention(dq, dk, dv),
             lambda: flash_attention(dq, k, v),
             lambda: linear_scan(*wkv, du, ds0),
             lambda: linear_scan(r, kk, vv, log_w, u, ds0)):
    try:
        call()
        refused.append("")
    except TypeError as e:
        refused.append(str(e))
out = flash_attention(*(t.to_local() for t in (dq, dk, dv)))
y, s_fin = linear_scan(*(t.to_local() for t in wkv), du.to_local(),
                       ds0.to_local())
y_ref, s_ref = linear_scan_plain(r, kk, vv, log_w, u, s0)
emit("refusal", refused=np.array(refused),
     flash_err=np.array(float((out - attention_ref(q, k, v)).abs().max())),
     wkv_err=np.array([float((y - y_ref).abs().max()),
                       float((s_fin - s_ref).abs().max())]))
"""


def test_wrappers_refuse_dtensors(tmp_path):
    """A DTensor reaching a wrapper would hand its raw pointers to the
    kernel on the card, so the wrappers refuse one on every device; the
    call on the local tensors is the plain version's."""
    got = run_ranks(REFUSAL, world=1, tmp_path=tmp_path)["refusal"]
    assert all("plain tensors, not DTensors" in str(m)
               for m in got["refused"]), got["refused"]
    assert float(got["flash_err"]) == 0.0
    assert got["wkv_err"].max() == 0.0
