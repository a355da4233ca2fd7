"""The port's autotuner (``repro_torch.kernels.autotune``) and the tuned
dispatch of ``repro_torch.kernels.ops``, on the CPU.

The contracts of ``tests/test_autotune.py`` re-expressed for the Hopper
kernels: candidates fit an SM's shared memory and include the default;
clamping and de-duplication at short sequences; a tight budget excludes
the big tile; a cache hit does zero timing; tune -> persist -> reload gives
the same plan with no re-timing; heuristic entries stay in-process;
explicit tiles bypass the tuner; ``tuned=True`` on a CPU tensor resolves
with zero timing.  The port's keys equal the reference's letter for letter.
Tile parity against the JAX package: the flash kernel's split algorithm at
128-key tiles (``flash_attention_split_plain(block_k=128)``) against the
Pallas kernel at (64, 128) in interpret mode, f32 at 2e-5 as in
``tests/test_torch_flash_split.py``; the WKV chunked body's algorithm at
32-step chunks against the Pallas kernel at chunk 32, 1e-4 as in
``tests/test_torch_wkv_chunked.py``.  The kernels themselves at the second
tiles run in ``tests/test_torch_gpu.py`` on the card.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)  # f32, test_torch_flash_split.py
WKV_TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_wkv_chunked.py


@pytest.fixture
def isolated_tuner(tmp_path, monkeypatch):
    """A fresh process-global tuner on an empty cache file; the committed
    baseline store does not leak in."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    monkeypatch.setattr(at, "BASELINE_CACHE_PATH",
                        str(tmp_path / "no_baseline.json"))
    at.reset_tuner()
    yield at.get_tuner()
    at.reset_tuner()


# ------------------------------------------------------------- candidates
@pytest.mark.parametrize("D,Dv,n", [(64, 64, 2), (64, 128, 2), (128, 128, 2),
                                    (192, 128, 2), (256, 128, 2),
                                    (256, 256, 1), (80, 80, 2), (96, 64, 2)])
def test_attention_candidates_fit_and_include_default(D, Dv, n):
    cands = at.attention_candidates(512, 512, D, Dv, BF16)
    assert len(cands) == n
    assert at.DEFAULT_ATTN in [c.as_dict() for c in cands]
    body = fa.body_of(BF16, D, Dv)
    for c in cands:
        assert c.block_q == 64 and c.block_k in fa.key_tiles(body, Dv)
        smem = at.attention_smem_bytes(c.block_q, c.block_k, D, Dv, BF16)
        assert smem <= at.SMEM_PER_BLOCK
        assert at.attention_ctas(c.block_q, c.block_k, D, Dv, BF16) >= 1


def test_fit_model_matches_the_sizing_table():
    """The wgmma body's bytes and CTAs an SM at 128-key tiles (the C
    entry's ``wg_smem_bytes``; the card checks the C side itself)."""
    table = {(64, 64): (74816, 2), (64, 128): (107584, 2),
             (128, 64): (115776, 1), (128, 128): (148544, 1),
             (192, 128): (189504, 1), (256, 128): (230464, 1)}
    for (D, Dv), want in table.items():
        assert (at.attention_smem_bytes(64, 128, D, Dv, BF16),
                at.attention_ctas(64, 128, D, Dv, BF16)) == want
    assert at.attention_smem_bytes(64, 128, 256, 256, BF16) == 296000
    assert at.attention_ctas(64, 128, 256, 256, BF16) == 0
    assert [at.scan_smem_bytes(c, 64) for c in (32, 64)] == [58896, 107024]


@pytest.mark.parametrize("D,Dv,block_k,padded,want", [
    (80, 80, 64, (128, 128), (83008, 2)),
    (80, 80, 128, (128, 128), (148544, 1)),
    (96, 64, 64, (128, 64), (66624, 2)),
    (96, 64, 128, (128, 64), (115776, 1))])
def test_fit_model_sizes_padded_head_dims_in_whole_boxes(D, Dv, block_k,
                                                        padded, want):
    """The wgmma body at D 80 and 96 keeps its tiles 128 columns wide (Dv
    80 too, Dv 64 stays 64): (80, 80) is sized as (128, 128), (96, 64) as
    (128, 64) -- the C entry's ``wg_smem_bytes`` over ``pad_box``."""
    assert (at.attention_smem_bytes(64, block_k, D, Dv, BF16),
            at.attention_ctas(64, block_k, D, Dv, BF16)) == want
    Dp, Dvp = fa.wgmma_widths(D, Dv)
    assert (Dp, Dvp) == padded
    assert at.attention_smem_bytes(64, block_k, D, Dv, BF16) == \
        at.attention_smem_bytes(64, block_k, Dp, Dvp, BF16)


@pytest.mark.parametrize("D,Dv,body", [
    (80, 80, "wgmma"), (96, 64, "wgmma"), (64, 64, "wgmma"),
    (256, 256, "wgmma"), (16, 16, "mma"), (32, 32, "mma"), (80, 64, "mma"),
    (96, 96, "mma"), (128, 80, "mma")])
def test_body_of_mirrors_the_c_selection(D, Dv, body):
    """bf16 takes wgmma exactly at the (D, Dv) pairs it is built for,
    with both key tiles at Dv <= 128; other widths (the smoke configs' 16
    and 32 among them) stay on mma.sync at 64 keys; f32 is the FMA body."""
    assert fa.body_of(BF16, D, Dv) == body
    assert fa.key_tiles(body, Dv) == ((64, 128) if body == "wgmma" and Dv <= 128
                                      else (64,))
    assert fa.body_of(F32, D, Dv) == "fma"


def test_f32_runs_one_tile():
    assert [c.as_dict() for c in at.attention_candidates(512, 512, 64, 64, F32)] \
        == [at.DEFAULT_ATTN]


def test_attention_candidates_clamp_to_short_sequences():
    cands = at.attention_candidates(32, 32, 64, 64, BF16)
    assert [c.as_dict() for c in cands] == [{"block_q": 64, "block_k": 64}]
    # a ragged sequence past one tile keeps both tiles, without duplicates
    cands = at.attention_candidates(100, 100, 64, 64, BF16)
    assert len({(c.block_q, c.block_k) for c in cands}) == len(cands) == 2


def test_scan_candidates_clamp_and_include_default():
    assert [c.chunk for c in at.scan_candidates(512, 64)] == [64, 32]
    short = [c.chunk for c in at.scan_candidates(16, 64)]
    assert short == [64, 32] and len(set(short)) == len(short)
    for c in at.scan_candidates(512, 64):
        assert at.scan_ctas(c.chunk, 64) >= 1


def test_tight_budget_excludes_the_big_tile():
    tight = at.attention_smem_bytes(64, 64, 64, 64, BF16) + at.SMEM_PER_CTA
    cands = at.attention_candidates(512, 512, 64, 64, BF16, smem_per_sm=tight)
    assert [c.as_dict() for c in cands] == [at.DEFAULT_ATTN]
    tight = at.scan_smem_bytes(32, 64) + at.SMEM_PER_CTA
    assert [c.chunk for c in at.scan_candidates(512, 64, smem_per_sm=tight)] \
        == [32]


def test_heuristics():
    # 128 keys where they cost no CTA an SM (D 64), else 64
    assert at.heuristic_attention(512, 512, 64, 64, BF16)["block_k"] == 128
    assert at.heuristic_attention(512, 512, 128, 128, BF16)["block_k"] == 64
    assert at.heuristic_attention(512, 512, 256, 256, BF16)["block_k"] == 64
    assert at.heuristic_attention(32, 32, 64, 64, BF16)["block_k"] == 64
    assert at.heuristic_scan(512, 64) == {"chunk": 64}
    assert at.heuristic_scan(16, 64) == {"chunk": 32}


# ---------------------------------------------------------------- caching
def _fake_measure(log):
    def measure(cfg):
        log.append(dict(cfg))
        # deterministic synthetic cost: prefer the largest tile
        return 1000.0 / float(sum(cfg.values()))
    return measure


def test_tune_picks_best_and_hit_does_zero_timing(isolated_tuner):
    tuner = isolated_tuner
    cands = at.attention_candidates(256, 256, 64, 64, BF16)
    log = []
    entry = tuner.tune("k1", cands, _fake_measure(log), mode="test")
    assert len(log) == len(cands) == tuner.timing_calls == 2
    assert entry["config"] == {"block_q": 64, "block_k": 128}
    log2 = []
    again = tuner.tune("k1", cands, _fake_measure(log2), mode="test")
    assert again == entry
    assert log2 == [] and tuner.timing_calls == len(cands)


def test_cache_round_trip_reload_without_retiming(isolated_tuner, tmp_path):
    tuner = isolated_tuner
    cands = at.scan_candidates(256, 64)
    entry = tuner.tune("scan-key", cands, _fake_measure([]), mode="test")
    assert os.path.exists(tuner.cache_path)

    def explode(cfg):
        raise AssertionError("re-timing after reload")

    fresh = at.Autotuner(cache_path=tuner.cache_path,
                         baseline_path=str(tmp_path / "none.json"))
    assert fresh.tune("scan-key", cands, explode, mode="test") == entry
    assert fresh.resolve("scan-key", explode) == entry["config"]
    assert fresh.timing_calls == 0


def test_baseline_merges_and_local_wins(tmp_path):
    base, local = tmp_path / "base.json", tmp_path / "local.json"
    base.write_text(json.dumps({"version": 1, "entries": {
        "shared": {"config": {"chunk": 32}, "mode": "cuda"},
        "base-only": {"config": {"chunk": 32}, "mode": "cuda"}}}))
    local.write_text(json.dumps({"version": 1, "entries": {
        "shared": {"config": {"chunk": 64}, "mode": "cuda"}}}))
    tuner = at.Autotuner(cache_path=str(local), baseline_path=str(base))
    assert tuner.lookup("shared")["config"] == {"chunk": 64}
    assert tuner.lookup("base-only")["config"] == {"chunk": 32}


def test_heuristic_entries_stay_in_process(isolated_tuner):
    tuner = isolated_tuner
    assert tuner.resolve("miss-key", lambda: {"chunk": 64}) == {"chunk": 64}
    assert tuner.timing_calls == 0
    assert not os.path.exists(tuner.cache_path)
    cands = at.scan_candidates(128, 64)
    entry = tuner.tune("miss-key", cands, _fake_measure([]), mode="test")
    assert entry["mode"] == "test"
    assert tuner.resolve("miss-key", lambda: {"chunk": 1}) == entry["config"]


def test_force_retune_overrides_cached_entry(isolated_tuner):
    tuner = isolated_tuner
    cands = at.scan_candidates(256, 64)
    tuner.tune("k", cands, _fake_measure([]), mode="test")
    log = []
    tuner.tune("k", cands, _fake_measure(log), mode="test", force=True)
    assert len(log) == len(cands)


def test_persist_merges_concurrent_writers(tmp_path):
    path = str(tmp_path / "cache.json")
    a = at.Autotuner(cache_path=path, baseline_path="")
    b = at.Autotuner(cache_path=path, baseline_path="")
    a.put("ka", {"config": {"chunk": 32}, "mode": "cuda"})
    b.put("kb", {"config": {"chunk": 64}, "mode": "cuda"})
    merged = at.Autotuner(cache_path=path, baseline_path="")
    assert merged.lookup("ka")["config"] == {"chunk": 32}
    assert merged.lookup("kb")["config"] == {"chunk": 64}


@pytest.mark.parametrize("dtypes", [(BF16, jnp.bfloat16), (F32, jnp.float32)])
@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_keys_equal_the_references(dtypes, backend):
    tdt, jdt = dtypes
    q, k, v = (1, 256, 4, 128), (1, 512, 2, 128), (1, 512, 2, 64)
    for causal, window in ((True, 0), (False, 0), (True, 128)):
        assert at.attention_key(q, k, v, tdt, causal=causal, window=window,
                                backend=backend) == jat.attention_key(
            q, k, v, jdt, causal=causal, window=window, backend=backend)
    assert at.scan_key((2, 100, 4, 64), F32, backend=backend) == \
        jat.scan_key((2, 100, 4, 64), jnp.float32, backend=backend)
    assert at.backend_tag(torch.device(backend)) == backend


def test_cache_keys_distinguish_backend_and_flags():
    shape = (1, 256, 2, 64)
    keys = {at.attention_key(shape, shape, shape, dt, causal=c, window=0,
                             backend=b)
            for dt, c, b in ((F32, True, "cpu"), (F32, False, "cpu"),
                             (F32, True, "cuda"), (BF16, True, "cpu"))}
    assert len(keys) == 4


# ------------------------------------------------------------ ops dispatch
def _attn_inputs(S=128, D=64, dtype=F32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, S, 2, D), generator=g, dtype=dtype)
            for _ in range(3)]


def test_explicit_tiles_bypass_tuner(monkeypatch):
    def explode():
        raise AssertionError("tuner consulted despite explicit tiles")

    monkeypatch.setattr(at, "get_tuner", explode)
    q, k, v = _attn_inputs()
    out = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=128,
                              tuned=True)
    np.testing.assert_allclose(out.numpy(),
                               attention_ref(q, k, v, causal=True).numpy(),
                               **FLASH_TOL)
    g = torch.Generator().manual_seed(1)
    args = [torch.randn((1, 64, 2, 16), generator=g) for _ in range(3)]
    args += [-torch.rand((1, 64, 2, 16), generator=g),
             torch.randn((2, 16), generator=g) * 0.1, torch.zeros((1, 2, 16, 16))]
    y, _ = ops.linear_scan(*args, chunk=32, tuned=True)
    np.testing.assert_allclose(y.numpy(), ls.linear_scan_plain(*args)[0].numpy(),
                               **WKV_TOL)


def test_tuned_dispatch_on_cpu_is_heuristic_with_zero_timing(isolated_tuner):
    tuner = isolated_tuner
    q, k, v = _attn_inputs()
    out = ops.flash_attention(q, k, v, causal=True, tuned=True)
    np.testing.assert_allclose(out.numpy(),
                               attention_ref(q, k, v, causal=True).numpy(),
                               **FLASH_TOL)
    key = at.attention_key(q.shape, k.shape, v.shape, F32, causal=True,
                           window=0, backend="cpu")
    assert tuner.lookup(key) == {"config": at.DEFAULT_ATTN, "mode": "heuristic"}
    g = torch.Generator().manual_seed(1)
    args = [torch.randn((1, 40, 2, 64), generator=g) for _ in range(3)]
    args += [-torch.rand((1, 40, 2, 64), generator=g),
             torch.randn((2, 64), generator=g) * 0.1, torch.zeros((1, 2, 64, 64))]
    ops.linear_scan(*args, tuned=True)
    assert tuner.timing_calls == 0
    assert not os.path.exists(tuner.cache_path)


def test_tuned_dispatch_prefers_cached_entry(isolated_tuner, monkeypatch):
    """A cached entry (the committed baseline's, or a tuned one) wins over
    the heuristic at dispatch, with zero timing; the wrapper gets its
    tile."""
    tuner = isolated_tuner
    q, k, v = _attn_inputs()
    key = at.attention_key(q.shape, k.shape, v.shape, F32, causal=True,
                           window=0, backend="cpu")
    tuner.put(key, {"config": {"block_q": 64, "block_k": 128},
                    "mode": "cuda"}, persist=False)
    seen = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: seen.append(kw["block_k"]) or real(*a, **kw))
    out = ops.flash_attention(q, k, v, causal=True, tuned=True)
    np.testing.assert_allclose(out.numpy(),
                               attention_ref(q, k, v, causal=True).numpy(),
                               **FLASH_TOL)
    assert seen == [128] and tuner.timing_calls == 0


def test_wrappers_refuse_unbuilt_tiles_on_the_card_only():
    """On a CPU tensor the plain versions ignore the tile; the checks that
    refuse a tile the kernel lacks sit on the CUDA path (run on the card in
    tests/test_torch_gpu.py)."""
    q, k, v = _attn_inputs()
    out = fa.flash_attention(q, k, v, block_k=96)
    np.testing.assert_allclose(out.numpy(), attention_ref(q, k, v).numpy(),
                               **FLASH_TOL)
    assert fa.key_tiles("wgmma", 128) == (64, 128)
    assert fa.key_tiles("wgmma", 256) == (64,)
    assert fa.key_tiles("mma", 64) == (64,)
    assert ls.scratch_floats(1, 100, 2, 16, 32) == 4 * 2 * 16 * 17
    assert ls.scratch_floats(1, 64, 2, 16, 64) == 0


def test_committed_baseline_cache_is_well_formed():
    path = at.BASELINE_CACHE_PATH
    if not os.path.exists(path):
        pytest.skip("no committed autotune baseline")
    with open(path) as f:
        data = json.load(f)
    assert data.get("entries"), "baseline cache is empty"
    for key, entry in data["entries"].items():
        assert entry["mode"] == "cuda" and key.split("|")[1] == "cuda"
        cfg = entry["config"]
        if key.startswith("flash_attention|"):
            assert set(cfg) == {"block_q", "block_k"}
            assert cfg["block_q"] == 64 and cfg["block_k"] in at.ATTN_BLOCK_K
        else:
            assert set(cfg) == {"chunk"} and cfg["chunk"] in at.SCAN_CHUNKS


# ------------------------------------------------- tile parity against JAX
FLASH_CASES = {
    # (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset)
    "causal": (1, 256, 256, 2, 2, 64, 64, True, 0, 0),
    "window": (1, 320, 320, 2, 2, 64, 64, True, 96, 0),
    "gqa_q_offset": (2, 128, 384, 4, 1, 64, 64, True, 0, 256),
    "gqa_ragged": (1, 100, 300, 4, 2, 64, 64, True, 0, 200),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_128_key_tiles_match_jax_kernel(name):
    B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset = FLASH_CASES[name]
    rng = np.random.RandomState(23)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv))]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = jops.flash_attention(*map(jnp.asarray, arrs), block_q=64,
                               block_k=128, interpret=True, **kw)
    plan = fa.split_plan(B, Sq, Skv, Hq, causal, window, q_offset, block_k=128)
    assert max(it[4] for it in plan.items) == -(-min(Skv, q_offset + Sq) // 128)
    out = fa.flash_attention_split_plain(*map(torch.from_numpy, arrs),
                                         block_k=128, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FLASH_TOL)


@pytest.mark.parametrize("case", [(1, 64, 2, 16), (2, 128, 2, 32),
                                  (1, 97, 2, 64), (2, 100, 2, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_32_step_chunks_match_jax_kernel(case):
    B, S, H, N = case
    rng = np.random.RandomState(S)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.uniform(-6.0, 0.0, (B, S, H, N))).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    arrs = (r, k, v, log_w, u, s0)
    jy, js = jops.linear_scan(*map(jnp.asarray, arrs), chunk=32,
                              interpret=True)
    trace = {}
    y, s_fin = ls.linear_scan_chunked_plain(*map(torch.from_numpy, arrs),
                                            chunk=32, trace=trace)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), **WKV_TOL)
    assert trace["max_exp_arg"] <= 0.0
    assert trace["start_states"].shape[1] == -(-S // 32)
