"""Training under a mesh on four cards, one NCCL rank each (``gpu``-marked:
skips with fewer than four cards; JAX-free, as the cards' machine has no
JAX).  The CPU tests hold the same paths on gloo ranks against JAX; here the
sharded runs are held against the port's own unsharded run on each card,
through ``sharded_vs_unsharded``, on the (data, model) meshes (4, 1), (2, 2)
and (1, 4).

* deepseek-v2 smoke (MLA + MoE, ``n_experts=8``, ``d_model=64``,
  ``_SMALL_T`` 16), f32, B 4 x S 32, through ``_moe_shard_map``
  (asserted), at ``capacity_factor = E / top_k`` (nothing dropped): the
  next-token loss to ``rtol 2e-4`` and its gradients to 1e-4 of max |g|;
* qwen2-vl smoke (GQA), B 4 x S 64: the total loss and every gradient.

On the cards' torch 2.11, DTensor refuses to flatten a batch- and
sequence- or head-sharded activation for a product, so every case whose
model axis is above 1 fails (ROADMAP §3, fault 3).  Those cases are strict
``xfail``: the day a torch version repairs it, they fail as passing.

* ``quantized_sum`` (``compressed_psum``'s int8 sum) over 4 ranks against
  a numpy transcription in f32, exactly; ``pipeline_apply`` over 4 stages
  against the sequential stages, 1e-5.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_mesh.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_ranks  # noqa: E402

pytestmark = pytest.mark.gpu

#: (config module, overrides, B, S, _SMALL_T, the loss compared)
CASES = {
    "moe": ("deepseek_v2_236b", dict(n_experts=8, d_model=64,
                                     capacity_factor=4.0), 4, 32, 16, "loss"),
    "gqa": ("qwen2_vl_72b", {}, 4, 64, 4096, "total_loss"),
}

MODEL = """
from repro_torch.models import LanguageModel, moe
import importlib

mod, kw, B, S, small_t, which = CASE
moe._SMALL_T = small_t
cfg = importlib.import_module("repro_torch.configs." + mod).smoke()
cfg = cfg.scaled(compute_dtype="float32", **kw)
model = LanguageModel(cfg, device=DEVICE)
params = model.init(0)  # the same seed, so the same weights, on every card
g = torch.Generator().manual_seed(1)
batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(DEVICE)
         for k in ("tokens", "targets")}
emit("case", **sharded_vs_unsharded(model, params, batch,
                                    small_mesh_info(MESH, device_type=DEVICE),
                                    which))
"""

COLLECTIVES = """
from repro_torch.distributed.collectives import quantized_sum
from repro_torch.distributed.pipeline import pipeline_apply

rng = np.random.RandomState(0)
x = rng.randn(WORLD, 64).astype(np.float32)
q, total, scale = quantized_sum(torch.from_numpy(x[RANK]).to(DEVICE),
                                dist.group.WORLD)
w = torch.from_numpy((rng.randn(WORLD, 8, 8) * 0.3).astype(np.float32)).to(DEVICE)
b = torch.full((WORLD, 8), 0.01, device=DEVICE)
h0 = torch.from_numpy(rng.randn(6, 2, 8).astype(np.float32)).to(DEVICE)
mesh = small_mesh_info((WORLD,), ("model",), device_type=DEVICE).mesh
out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                     {"w": w, "b": b}, h0, mesh, axis="model")
h = h0
for i in range(WORLD):
    h = torch.tanh(h @ w[i] + b[i])
emit("coll", x=x, total=total.cpu().numpy(), scale=scale.cpu().numpy(),
     pipe_err=np.array([float((out - h).abs().max())]))
"""

FAULT_3 = pytest.mark.xfail(
    strict=True, raises=AssertionError,
    reason="ROADMAP §3 fault 3: torch 2.11's DTensor cannot flatten a "
           "sharded dim that is not the first (aten.view in a product)")


def _four_cards(body: str, tmp_path) -> dict:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return run_ranks(body, world=4, tmp_path=tmp_path, timeout=150,
                     backend="nccl")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh", [
    pytest.param((4, 1), id="4x1"),
    pytest.param((2, 2), id="2x2", marks=FAULT_3),
    pytest.param((1, 4), id="1x4", marks=FAULT_3)])
def test_mesh_paths_on_four_cards(name, mesh, tmp_path):
    got = _four_cards(f"CASE = {CASES[name]!r}\nMESH = {mesh!r}\n" + MODEL,
                      tmp_path)["case"]
    assert str(got["device"]) == "cuda"
    unsharded, sharded = got["loss"]
    np.testing.assert_allclose(sharded, unsharded, rtol=2e-4)
    if name == "moe":
        assert list(got["calls"]) == [0, 2], got["calls"]
    assert got["grad_err"].max() < 1e-4, got["grad_err"]


def test_collectives_on_four_cards(tmp_path):
    coll = _four_cards(COLLECTIVES, tmp_path)["coll"]
    x = coll["x"]
    scale = np.float32(np.max(np.abs(x)) / np.float32(127.0))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    assert coll["scale"] == scale
    np.testing.assert_array_equal(coll["total"], q.sum(axis=0))
    assert coll["pipe_err"][0] < 1e-5, coll["pipe_err"]
