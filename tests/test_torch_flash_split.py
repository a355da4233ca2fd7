"""The wgmma body's split-KV algorithm on the CPU.

``flash_attention_split_plain`` is the plain twin of the kernel's split and
merge path: per work item of ``split_plan`` it computes f32 partials (o, m,
l) and merges each split unit's parts with the merge kernel's formula.  It
is held against ``attention_ref`` (f32, 2e-5) and against the JAX Pallas
kernel in interpret mode, on numpy inputs as in ``test_torch_kernels.py``;
the plan itself is checked for coverage, its cap and its order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)

SPLIT_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, residual)
    # four of test_torch_kernels.CASES (q_offset = Skv - Sq when causal)
    "mqa": (2, 256, 256, 4, 1, 64, 64, True, 0, 0, False),
    "q_offset": (1, 128, 384, 2, 2, 64, 64, True, 0, 256, False),
    "window": (1, 256, 256, 2, 2, 64, 64, True, 128, 0, False),
    "ragged_100_300": (1, 100, 300, 2, 2, 64, 64, True, 48, 200, False),
    # rows past Skv + window see no key: their parts keep l = 0
    "part_without_keys": (1, 200, 160, 2, 1, 32, 32, True, 40, 100, False),
    "epilogue_residual": (2, 150, 150, 4, 2, 64, 32, True, 0, 0, True),
}


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, D, Dv, *_rest, residual = case
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)]
    if residual:
        shapes.append((B, Sq, Hq, Dv))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _kw(case, arrs):
    *_, causal, window, q_offset, residual = case
    res = torch.from_numpy(arrs[3]) if residual else None
    return dict(causal=causal, window=window, q_offset=q_offset,
                out_scale=0.5 if residual else 1.0, residual=res)


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plain_matches_reference(name):
    case = SPLIT_CASES[name]
    arrs = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    kw = _kw(case, arrs)
    plan = fa.split_plan(*case[:2], case[2], case[3], case[7], case[8], case[9])
    assert plan.merges, "the case must split at least one unit"
    out = fa.flash_attention_split_plain(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plain_matches_jax_kernel(name):
    case = SPLIT_CASES[name]
    arrs = _inputs(case, seed=1)
    kw = _kw(case, arrs)
    jx = [jnp.asarray(a) for a in arrs]
    ref = jops.flash_attention(
        jx[0], jx[1], jx[2], causal=kw["causal"], window=kw["window"],
        q_offset=kw["q_offset"], out_scale=kw["out_scale"],
        residual=jx[3] if len(jx) > 3 else None, interpret=True)
    out = fa.flash_attention_split_plain(
        *(torch.from_numpy(a) for a in arrs[:3]), **kw)
    # rows that see no key: the port outputs 0 (the l == 0 rule, held above
    # against attention_ref); the JAX kernel's finite NEG_INF spreads them
    # over the masked keys, so only rows that see a key are compared
    Sq, Skv = case[1], case[2]
    pos_q = kw["q_offset"] + np.arange(Sq)
    seen = pos_q >= 0
    if kw["window"]:
        seen &= pos_q - kw["window"] + 1 < Skv
    np.testing.assert_allclose(out.numpy()[:, seen], np.asarray(ref)[:, seen],
                               **F32)


def test_split_part_without_keys_gives_zero_sum():
    """In ``part_without_keys`` some rows of a split unit see no key in one
    part (l = 0 there) and keys in another; rows with no key at all output
    0 (before the epilogue)."""
    case = SPLIT_CASES["part_without_keys"]
    B, Sq, Skv, Hq, _, _, _, causal, window, q_offset, _ = case
    plan = fa.split_plan(B, Sq, Skv, Hq, causal, window, q_offset)
    pos_q = q_offset + np.arange(Sq)
    empty_part = False
    for b, h, qt, slot0, n in plan.merges:
        parts = [it for it in plan.items if it[:3] == (b, h, qt)]
        assert len(parts) == n
        for _, _, _, kt0, kt1, _ in parts:
            k0, k1 = kt0 * 64, min(kt1 * 64, Skv)
            rows = pos_q[qt * 64:(qt + 1) * 64]
            keys = np.arange(k0, k1)
            vis = (keys[None] <= rows[:, None]) & (rows[:, None] - keys[None] < window)
            empty_part |= bool((~vis.any(1)).any())
    assert empty_part
    arrs = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    out = fa.flash_attention_split_plain(q, k, v, **_kw(case, arrs))
    blind = pos_q - window + 1 >= Skv  # the window has passed every key
    assert blind.any()
    assert torch.equal(out[:, blind], torch.zeros_like(out[:, blind]))


PLAN_SHAPES = [
    # (B, Sq, Skv, Hq, causal, window, q_offset): the gemma-2b trace's
    # prompts, deepseek-7b, windows, q_offset, bidirectional, ragged
    (1, 97, 97, 8, True, 0, 0), (1, 351, 351, 8, True, 0, 0),
    (1, 1000, 1000, 8, True, 0, 0), (1, 2048, 2048, 32, True, 0, 0),
    (1, 1024, 1024, 32, True, 256, 0), (1, 256, 1280, 8, True, 0, 1024),
    (2, 130, 130, 4, False, 0, 0), (1, 100, 300, 2, True, 48, 200),
    (1, 200, 160, 2, True, 40, 100),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_split_plan_covers_each_visible_tile_once(shape):
    B, Sq, Skv, Hq, causal, window, q_offset = shape
    plan = fa.split_plan(*shape)
    pq = q_offset + np.arange(Sq)[:, None]
    pk = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= pk <= pq
    if window:
        vis &= pq - pk < window
    n_qt, n_kt = -(-Sq // 64), -(-Skv // 64)
    tile_vis = np.zeros((n_qt, n_kt), bool)
    for qt in range(n_qt):
        for kt in range(n_kt):
            tile_vis[qt, kt] = vis[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64].any()
    seen = np.zeros((B, Hq, n_qt, n_kt), int)
    units = set()
    for b, h, qt, kt0, kt1, _ in plan.items:
        seen[b, h, qt, kt0:kt1] += 1
        units.add((b, h, qt))
    assert len(units) == B * Hq * n_qt  # every unit has an item (its output)
    assert (seen == tile_vis[None, None].astype(int)).all()  # once; no masked tile


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_split_plan_caps_parts_and_orders_heaviest_first(shape):
    B, Sq, Skv, Hq, causal, window, q_offset = shape
    plan = fa.split_plan(*shape)
    lens = [kt1 - kt0 for *_, kt0, kt1, _ in plan.items]
    assert lens == sorted(lens, reverse=True)
    total = sum(lens)
    cap = max(1, -(-total // fa.N_SM))
    for b, h, qt, slot0, n in plan.merges:
        parts = [it for it in plan.items if it[5] >= 0 and it[:3] == (b, h, qt)]
        assert sorted(it[5] for it in parts) == list(range(slot0, slot0 + n))
        assert all(kt1 - kt0 <= cap for *_, kt0, kt1, _ in parts)
        starts = sorted((it[5], it[3], it[4]) for it in parts)  # slot order = key order
        assert all(a[2] == b_[1] for a, b_ in zip(starts, starts[1:]))
    assert plan.n_slots == sum(n for *_, n in plan.merges)


def test_split_plan_critical_paths_at_the_gemma_trace():
    """The longest item at the gemma-2b prompts: 16 tiles down to 9 at
    S = 1000, 6 down to 2 at S = 351; deepseek-7b (1024 units) is not
    split."""
    def longest(S, H=8):
        plan = fa.split_plan(1, S, S, H, True, 0, 0)
        return max(kt1 - kt0 for *_, kt0, kt1, _ in plan.items)

    assert longest(1000) == 9
    assert longest(351) == 2
    assert not fa.split_plan(1, 2048, 2048, 32, True, 0, 0).merges
