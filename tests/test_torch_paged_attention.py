"""The paged decode-attention kernel's algorithm on the CPU: its plain twin
(``kernels/paged_attention.py::paged_attention_split_plain``: the page-range
split, each live range's partial, the fixed-order merge) against the gather
path (``kernels/ops.py::paged_attention_gather``) that ``ops.paged_attention``
runs on a CPU tensor; and the decode step's values its layers share (RoPE's
sin and cos, the paged append's rows).  The kernel itself runs only on a
card (``tests/test_torch_gpu.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

HKV = 2


def _paged_inputs(G, D, ps, dtype=torch.float32, seed=0):
    """Six slots over a shuffled pool, as the engine leaves it: pos_q (the
    query's position, its own key already written) ends on a page edge,
    starts a slot, fills the row, is inactive (-1), or is ragged; each slot
    holds a spare page past its query's page (stale K/V, positions -1, as
    a recycled page after the allocation-time reset), one slot has an
    unallocated entry inside its live range, the rest of each row is
    unallocated (== n_pages), and the trash page holds NaN, inf and
    positions the mask would pass."""
    rng = np.random.RandomState(seed)
    P = 20
    pos_q = [3 * ps - 1, 0, P * ps - 1, -1, 37, 5 * ps + 3]
    B = len(pos_q)
    n_pages = B * P
    kp = torch.from_numpy(rng.randn(n_pages + 1, ps, HKV, D)).float()
    vp = torch.from_numpy(rng.randn(n_pages + 1, ps, HKV, D)).float()
    posp = torch.full((n_pages + 1, ps), -1, dtype=torch.int32)
    kp[n_pages], vp[n_pages] = math.nan, math.inf
    posp[n_pages] = torch.arange(ps, dtype=torch.int32)
    free = rng.permutation(n_pages).tolist()
    table = torch.full((B, P), n_pages, dtype=torch.int32)
    for b, pq in enumerate(pos_q):
        used = min(P, max(pq, 0) // ps + 2)
        for lp in range(used):
            page = free.pop()
            table[b, lp] = page
            t = lp * ps + torch.arange(ps)
            posp[page] = torch.where(t <= pq, t, -1).int()
    table[4, 1] = n_pages  # a hole inside slot 4's live pages
    q = torch.from_numpy(rng.randn(B, 1, HKV * G, D)).float()
    pos_q = torch.tensor(pos_q, dtype=torch.int32)[:, None]
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), posp, table, pos_q)


@pytest.mark.parametrize("window", [0, 40], ids=["full", "window"])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_paged_split_plain_matches_gather_path(G, D, ps, window):
    """The twin, at the split the kernel would run (two ranges of 10 pages
    at 16-token pages, five of 4 at 32: the long rows span them all),
    equals the gather path on active rows (f32, both sum in f32: 1e-5) and
    gives zeros on the inactive row; the trash page's NaN and inf never
    reach an output."""
    args = _paged_inputs(G, D, ps)
    q, kp, vp, posp, table, pos_q = args
    pages, n_ranges = pa.page_split(q.shape[0], HKV, G, table.shape[1], ps)
    assert (pages, n_ranges) == ((10, 2) if ps == 16 else (4, 5))
    twin = pa.paged_attention_split_plain(*args, window=window)
    gather = ops.paged_attention(*args, window=window)
    assert twin.shape == gather.shape == q.shape
    assert torch.isfinite(twin).all()
    active = pos_q[:, 0] >= 0
    torch.testing.assert_close(twin[active], gather[active], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(twin[~active], torch.zeros_like(twin[~active]))


def test_page_split_at_the_served_shapes():
    """granite-moe-1b-a400m's serve cells (64 slots, 8 kv heads, G 2,
    16-token pages): 16 ranges of 16 pages at 256 pages a row, 8 of 8 at
    64; a smoke engine's 3 slots: one range of 8 pages (128 keys)."""
    assert pa.page_split(64, 8, 2, 256, 16) == (16, 16)
    assert pa.page_split(64, 8, 2, 64, 16) == (8, 8)
    assert pa.page_split(3, 2, 2, 8, 16) == (8, 1)
    assert pa.group_chunk(8) == 8 and pa.group_chunk(6) == 2
    assert pa.group_chunk(16) == 8 and pa.group_chunk(3) == 1


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_paged_split_plain_many_ranges_bf16(causal, monkeypatch):
    """bf16 pools and q at granite's head shape (G 2, D 64) with 16-key
    ranges, so each live row merges up to 20 partials: the twin (f32 inside,
    one rounding) against the gather path (f32 scores, bf16 P V), within
    bf16's rounding."""
    monkeypatch.setattr(pa, "MIN_RANGE_KEYS", 16)
    args = _paged_inputs(2, 64, 16, dtype=torch.bfloat16, seed=1)
    pages, n_ranges = pa.page_split(6, HKV, 2, 20, 16)
    assert (pages, n_ranges) == (1, 20)
    twin = pa.paged_attention_split_plain(*args, causal=causal)
    gather = ops.paged_attention(*args, causal=causal)
    active = args[-1][:, 0] >= 0
    assert twin.dtype == torch.bfloat16
    torch.testing.assert_close(twin[active].float(), gather[active].float(),
                               rtol=2e-2, atol=2e-2)


def test_paged_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The kernel wrapper takes CUDA tensors only (``ops`` runs the gather
    path on a CPU tensor) and checks shapes and dtypes before any launch."""
    args = _paged_inputs(2, 64, 16)
    before = pa.launches
    with pytest.raises(ValueError, match="CPU tensor"):
        pa.paged_attention(*args)
    q, kp, vp, posp, table, pos_q = args
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q[..., :48], kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), posp, table, pos_q)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kp, vp, posp.long(), table, pos_q)
    with pytest.raises(ValueError, match="pos_q"):
        pa.paged_attention(q, kp, vp, posp, table, pos_q[:, 0])
    assert pa.launches == before


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-vl-72b"])
def test_decode_step_shares_rope_and_paged_rows_across_layers(arch,
                                                             monkeypatch):
    """One paged decode step computes RoPE's sin and cos and the pool rows
    it appends to once (``decode_step`` into ``ModelCtx.rope`` and
    ``page_rows``), and every layer uses them: the step's logits and pools
    equal, bit for bit, those of a step whose layers each compute their
    own."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.train import smoke_config
    from repro_torch.models import LanguageModel, attention
    from repro_torch.utils import tree_leaves, tree_map

    cfg = smoke_config(arch).scaled(n_layers=4)
    model = LanguageModel(cfg, device="cpu")
    params = model.init(0)
    P, n_pages = 8, 32
    cache = model.init_cache(4, P * 16, dtype=torch.float32,
                             pages=(n_pages, 16))
    table = torch.arange(n_pages, dtype=torch.int32).reshape(4, P)
    pos = torch.tensor([5, 17, -1, 40], dtype=torch.int32)
    tokens = torch.tensor([[3], [7], [0], [11]], dtype=torch.int32)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"sin": 0, "gather": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    def step():
        count = Count()
        with count:
            logits, c = model.decode_step(params, tokens,
                                          tree_map(torch.clone, cache), pos,
                                          table=table)
        return logits, tree_leaves(c), count.n

    logits, leaves, n = step()
    assert n == {"sin": 1, "gather": 1}
    # every layer computes its own: no sin and cos in the context, and each
    # append finds its rows through the table itself
    append = attention.paged_append

    def own_rows(c, k, v, p, rows):
        return append(c, k, v, p, attention.paged_rows(
            p, table, c["pos"].shape[0] - 1, c["pos"].shape[1]))

    monkeypatch.setattr(model, "_step_shared", lambda *a: {})
    monkeypatch.setattr(attention, "paged_append", own_rows)
    ref, ref_leaves, n_ref = step()
    assert n_ref == {"sin": 4, "gather": 4}  # once a layer
    assert torch.equal(logits, ref)
    assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))
