"""The port's recurrent blocks against the JAX package on the same numpy inputs.

* The WKV scan's plain version (``linear_scan_plain``, what ``linear_scan``
  runs on a CPU tensor) and the per-step oracle ``wkv_ref`` against JAX's
  Pallas kernel in interpret mode and JAX's ``wkv_ref``, on
  ``tests/test_kernels.py``'s cases and bounds (1e-4 on ``y`` and ``s_fin``).
* The wrapper refuses what the CUDA kernel does not take.
* The time mix and channel mix against JAX on the same weights (f32), in
  prefill, in chunked prefill from a nonzero state, and in decode with an
  ``active`` mask, whose inactive rows must keep their state bit for bit.
* RG-LRU against JAX's ``apply_rglru`` (f32, rtol = atol = 1e-5) in train,
  prefill, chunked prefill from a nonzero state (split off the conv
  width) and decode with an ``active`` mask; a 2-token prompt (shorter
  than the conv window) against JAX's token-by-token decode; and the
  log-depth scan against the per-step recurrence.

The CUDA kernel itself is checked on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_9b as jax_rg  # noqa: E402
from repro.configs import rwkv6_1_6b as jax_rwkv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import wkv_ref as jax_wkv_ref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as torch_rg  # noqa: E402
from repro_torch.configs import rwkv6_1_6b as torch_rwkv  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import wkv_ref  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py's WKV bounds

WKV_CASES = [
    # (B, S, H, N, chunk): tests/test_kernels.py's WKV_CASES, then its padded
    # S = 100 case (pads to 128 at chunk 32)
    (1, 64, 2, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 128, 4, 64, 64),
    (2, 96, 2, 16, 32),
    (2, 100, 2, 32, 32),
]


def _wkv_inputs(B, S, H, N, seed=0):
    """tests/test_kernels.py::_wkv_inputs' distributions, drawn with numpy:
    realistic decays log_w = -exp(w_raw), w_raw in [-6, 0]; nonzero s0."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.uniform(-6.0, 0.0, (B, S, H, N))).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    return r, k, v, log_w, u, s0


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_wkv_plain_matches_jax_kernel(case):
    B, S, H, N, chunk = case
    arrs = _wkv_inputs(B, S, H, N, seed=S)
    jy, js = jops.linear_scan(*map(jnp.asarray, arrs), chunk=chunk,
                              interpret=True)
    before = ls.launches
    y, s_fin = kops.linear_scan(*map(torch.from_numpy, arrs), chunk=chunk)
    assert ls.launches == before  # a CPU tensor never launches the kernel
    assert y.shape == (B, S, H, N) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("case", WKV_CASES[:1] + WKV_CASES[-1:],
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_ref_matches_jax_ref(case):
    B, S, H, N, _ = case
    arrs = _wkv_inputs(B, S, H, N, seed=S + 1)
    jy, js = jax_wkv_ref(*map(jnp.asarray, arrs))
    y, s_fin = wkv_ref(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), **TOL)


def test_wkv_plain_equals_ref_across_chunks():
    """The pad-to-chunk plain version is the per-step recurrence whatever
    the chunk (odd length 97: 2 padded chunks of 64, or 4 of 32)."""
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(1, 97, 2, 64, seed=7)]
    y_ref, s_ref = wkv_ref(*arrs)
    for chunk in (64, 32, 97, 1000):
        y, s_fin = ls.linear_scan_plain(*arrs, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
        np.testing.assert_allclose(s_fin.numpy(), s_ref.numpy(), **TOL)


def test_linear_scan_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, log_w, u, s0 = map(torch.from_numpy, _wkv_inputs(1, 8, 2, 16))
    with pytest.raises(TypeError):  # not f32
        kops.linear_scan(r.double(), k, v, log_w, u, s0)
    with pytest.raises(TypeError):
        kops.linear_scan(r, k, v, log_w, u.to(torch.bfloat16), s0)
    bad_n = [torch.zeros(1, 8, 2, 24)] * 4
    with pytest.raises(ValueError):  # N outside {16, 32, 64}
        kops.linear_scan(*bad_n, torch.zeros(2, 24), torch.zeros(1, 2, 24, 24))
    with pytest.raises(ValueError):  # mismatched sequence shapes
        kops.linear_scan(r, k[:, :4].contiguous(), v, log_w, u, s0)
    with pytest.raises(ValueError):  # u of the wrong shape
        kops.linear_scan(r, k, v, log_w, u[:1].contiguous(), s0)
    with pytest.raises(ValueError):  # s0 of the wrong shape
        kops.linear_scan(r, k, v, log_w, u, s0[..., :8].contiguous())
    with pytest.raises(ValueError):  # empty sequence
        kops.linear_scan(*[t[:, :0] for t in (r, k, v, log_w)], u, s0)
    with pytest.raises(ValueError):  # mixed devices
        kops.linear_scan(r, k, v, log_w, u, s0.to("meta"))
    with pytest.raises(ValueError):  # no kernel for this device
        kops.linear_scan(*(t.to("meta") for t in (r, k, v, log_w, u, s0)))
    with pytest.raises(ValueError):  # non-contiguous
        kops.linear_scan(r.transpose(2, 3), k, v, log_w, u, s0)


# ---------------------------------------------------------------------------
# Time mix and channel mix against JAX
# ---------------------------------------------------------------------------

B, S = 3, 12


def _cfgs():
    return (jax_rwkv.smoke().scaled(compute_dtype="float32"),
            torch_rwkv.smoke().scaled(compute_dtype="float32"))


def _weights(init, seed):
    """JAX-drawn weights as numpy, with every vector and ``u`` moved off its
    init value (ones, halves, the w0 ramp) so that each one shows."""
    jcfg, _ = _cfgs()
    vals, _ = split(init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    return {k: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
                ).astype(np.float32)
            for k, v in vals.items()}


def _state(seed, nonzero=True):
    jcfg, _ = _cfgs()
    h, n = jcfg.d_model // jcfg.rwkv_head_size, jcfg.rwkv_head_size
    rng = np.random.RandomState(seed)
    shapes = {"S": (B, h, n, n), "x_tm": (B, jcfg.d_model),
              "x_cm": (B, jcfg.d_model)}
    return {k: (rng.standard_normal(s) * (0.5 if nonzero else 0.0)
                ).astype(np.float32) for k, s in shapes.items()}


def _run_both(mode, state, active=None, seq=S):
    jcfg, tcfg = _cfgs()
    tm = _weights(jrec.init_rwkv_time_mix, 1)
    cm = _weights(jrec.init_rwkv_channel_mix, 2)
    x = np.random.RandomState(3).standard_normal(
        (B, seq, jcfg.d_model)).astype(np.float32)

    def jax_side():
        st = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
        jact = None if active is None else jnp.asarray(active)
        jp = {k: jnp.asarray(v) for k, v in tm.items()}
        y1, st = jrec.apply_rwkv_time_mix(jp, jcfg, jnp.asarray(x), st, mode,
                                          active=jact)
        jp = {k: jnp.asarray(v) for k, v in cm.items()}
        y2, st = jrec.apply_rwkv_channel_mix(jp, jcfg, jnp.asarray(x), st, mode,
                                             active=jact)
        return y1, y2, st

    def torch_side():
        st = None if state is None else {k: torch.from_numpy(v.copy())
                                         for k, v in state.items()}
        tact = None if active is None else torch.from_numpy(active)
        tp = {k: torch.from_numpy(v) for k, v in tm.items()}
        y1, st = trec.apply_rwkv_time_mix(tp, tcfg, torch.from_numpy(x), st,
                                          mode, active=tact)
        tp = {k: torch.from_numpy(v) for k, v in cm.items()}
        y2, st = trec.apply_rwkv_channel_mix(tp, tcfg, torch.from_numpy(x), st,
                                             mode, active=tact)
        return y1, y2, st

    return jax_side(), torch_side()


def _compare(jres, tres):
    for j, t in zip(jres[:2], tres[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    if jres[2] is None:
        assert tres[2] is None
        return
    for key in ("S", "x_tm", "x_cm"):
        np.testing.assert_allclose(tres[2][key].numpy(), np.asarray(jres[2][key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("mode,nonzero", [("prefill", False),
                                          ("chunk_prefill", True),
                                          ("train", False)])
def test_time_and_channel_mix_match_jax(mode, nonzero, monkeypatch):
    """prefill and chunk_prefill go through ``kops.linear_scan`` (once per
    time mix); train does not."""
    calls = []
    real = kops.linear_scan
    monkeypatch.setattr(kops, "linear_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    state = None if mode == "train" else _state(4, nonzero)
    jres, tres = _run_both(mode, state)
    _compare(jres, tres)
    assert len(calls) == (0 if mode == "train" else 1)


def test_decode_with_active_mask_matches_jax_and_keeps_inactive_state():
    state = _state(5)
    active = np.array([True, False, True])
    jres, tres = _run_both("decode", state, active=active, seq=1)
    _compare(jres, tres)
    for key in ("S", "x_tm", "x_cm"):
        assert torch.equal(tres[2][key][1], torch.from_numpy(state[key][1])), key
        assert not torch.equal(tres[2][key][0], torch.from_numpy(state[key][0]))


def test_state_is_updated_in_place():
    """The caller's cache tensors are the ones written (engines drop the
    returned cache and keep theirs)."""
    state = {k: torch.from_numpy(v) for k, v in _state(6).items()}
    ids = {k: v.data_ptr() for k, v in state.items()}
    before = {k: v.clone() for k, v in state.items()}
    _, tcfg = _cfgs()
    tm = {k: torch.from_numpy(v) for k, v in
          _weights(jrec.init_rwkv_time_mix, 1).items()}
    cm = {k: torch.from_numpy(v) for k, v in
          _weights(jrec.init_rwkv_channel_mix, 2).items()}
    x = torch.randn(B, 4, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    _, out = trec.apply_rwkv_time_mix(tm, tcfg, x, state, "chunk_prefill")
    assert out is state and torch.equal(state["x_cm"], before["x_cm"])
    _, out = trec.apply_rwkv_channel_mix(cm, tcfg, x, state, "chunk_prefill")
    for k in state:
        assert state[k].data_ptr() == ids[k]
        assert not torch.equal(state[k], before[k]), k


# ---------------------------------------------------------------------------
# RG-LRU against JAX
# ---------------------------------------------------------------------------

RG_TOL = dict(rtol=1e-5, atol=1e-5)


def _rg_cfgs():
    return (jax_rg.smoke().scaled(compute_dtype="float32"),
            torch_rg.smoke().scaled(compute_dtype="float32"))


def _rg_weights(seed=1):
    """JAX-drawn RG-LRU weights as numpy, every leaf moved by 0.05 x a
    seeded normal, and ``conv_w`` drawn at 0.5 x a normal: JAX inits it to
    zeros, which zeros ``u`` and with it the gates, the scan and the
    output."""
    jcfg, _ = _rg_cfgs()
    vals, _ = split(jrec.init_rglru(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    out = {k: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
               ).astype(np.float32) for k, v in vals.items()}
    out["conv_w"] = (0.5 * rng.standard_normal(out["conv_w"].shape)
                     ).astype(np.float32)
    return out


def _rg_state(seed, batch=B, nonzero=True):
    jcfg, _ = _rg_cfgs()
    w, cw = jcfg.lru_width, jcfg.conv_width
    rng = np.random.RandomState(seed)
    scale = 0.5 if nonzero else 0.0
    return {"h": (rng.standard_normal((batch, w)) * scale).astype(np.float32),
            "conv": (rng.standard_normal((batch, cw - 1, w)) * scale
                     ).astype(np.float32)}


def _rg_x(seq, batch=B, seed=3):
    jcfg, _ = _rg_cfgs()
    return np.random.RandomState(seed).standard_normal(
        (batch, seq, jcfg.d_model)).astype(np.float32)


def _rg_jax(mode, x, state, active=None):
    jcfg, _ = _rg_cfgs()
    p = {k: jnp.asarray(v) for k, v in _rg_weights().items()}
    st = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    act = None if active is None else jnp.asarray(active)
    y, st = jrec.apply_rglru(p, jcfg, jnp.asarray(x), st, mode, active=act)
    return (np.asarray(y),
            None if st is None else {k: np.asarray(v) for k, v in st.items()})


def _rg_torch(mode, x, state, active=None):
    """The port's output and state; ``state`` (torch tensors) is written in
    place."""
    _, tcfg = _rg_cfgs()
    p = {k: torch.from_numpy(v) for k, v in _rg_weights().items()}
    act = None if active is None else torch.from_numpy(active)
    y, st = trec.apply_rglru(p, tcfg, torch.from_numpy(x), state, mode,
                             active=act)
    return y.numpy(), st


def _as_torch(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _rg_compare(jres, tres):
    np.testing.assert_allclose(tres[0], jres[0], **RG_TOL)
    if jres[1] is None:
        assert tres[1] is None
        return
    for key in ("h", "conv"):
        np.testing.assert_allclose(tres[1][key].numpy(), jres[1][key],
                                   err_msg=key, **RG_TOL)


@pytest.mark.parametrize("mode,nonzero", [("train", False),
                                          ("prefill", False),
                                          ("chunk_prefill", True)])
def test_rglru_matches_jax(mode, nonzero):
    x = _rg_x(S)
    state = None if mode == "train" else _rg_state(4, nonzero=nonzero)
    jres = _rg_jax(mode, x, state)
    tres = _rg_torch(mode, x, None if state is None else _as_torch(state))
    _rg_compare(jres, tres)


def test_rglru_chunked_prefill_split_off_conv_width_matches_jax():
    """Chunked prefill from a nonzero state in two chunks split at 5 (not a
    multiple of the conv width 4): the conv window and ``h`` carry across,
    against JAX over the same chunks and against one chunk of the whole."""
    x = _rg_x(S)
    state = _rg_state(5)
    jy1, jst = _rg_jax("chunk_prefill", x[:, :5], state)
    jy2, jst = _rg_jax("chunk_prefill", x[:, 5:], jst)
    tst = _as_torch(state)
    ty1, _ = _rg_torch("chunk_prefill", x[:, :5], tst)
    ty2, _ = _rg_torch("chunk_prefill", x[:, 5:], tst)
    _rg_compare((np.concatenate([jy1, jy2], 1), jst),
                (np.concatenate([ty1, ty2], 1), tst))
    _rg_compare(_rg_jax("chunk_prefill", x, state),
                (np.concatenate([ty1, ty2], 1), tst))


def test_rglru_decode_with_active_mask_matches_jax_and_keeps_inactive_state():
    state = _rg_state(6)
    active = np.array([True, False, True])
    x = _rg_x(1)
    jres = _rg_jax("decode", x, state, active=active)
    tst = _as_torch(state)
    tres = _rg_torch("decode", x, tst, active=active)
    _rg_compare(jres, tres)
    for key in ("h", "conv"):
        assert torch.equal(tst[key][1], torch.from_numpy(state[key][1])), key
        assert not torch.equal(tst[key][0], torch.from_numpy(state[key][0]))


def test_rglru_two_token_prompt_matches_jax_token_by_token():
    """A prompt shorter than the conv window (cw - 1 = 3): the port's
    prefill left-pads the conv state with zeros (a divergence by design:
    JAX keeps a 2-row history no (B, 3, w) slot can hold).  Prefill then
    decode equals JAX decoding every token from a zero state."""
    jcfg, tcfg = _rg_cfgs()
    x = _rg_x(5)
    jst = {k: np.asarray(v) for k, v in jrec.make_rglru_state(B, jcfg).items()}
    jys = []
    for t in range(5):
        y, jst = _rg_jax("decode", x[:, t:t + 1], jst)
        jys.append(y)
    tst = trec.make_rglru_state(B, tcfg, device="cpu")
    ty, _ = _rg_torch("prefill", x[:, :2], tst)
    np.testing.assert_allclose(ty, np.concatenate(jys[:2], 1), **RG_TOL)
    assert torch.equal(tst["conv"][:, 0], torch.zeros_like(tst["conv"][:, 0]))
    for t in range(2, 5):
        ty, _ = _rg_torch("decode", x[:, t:t + 1], tst)
        np.testing.assert_allclose(ty, jys[t], err_msg=f"step {t}", **RG_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(tst[key].numpy(), jst[key], err_msg=key,
                                   **RG_TOL)


@pytest.mark.parametrize("seq", [1, 3, 64, 257])
def test_rglru_scan_matches_per_step_recurrence(seq):
    """The log-depth doubling scan against ``h_t = a_t h_{t-1} + b_t`` step
    by step (the decode path's update), and ``a_cum`` against the running
    product, at lengths 1, 3, a power of two and one past it."""
    rng = np.random.RandomState(seq)
    a = torch.from_numpy(np.exp(-rng.uniform(0.0, 0.7, (2, seq, 8))
                                ).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, seq, 8)).astype(np.float32))
    a_cum, h = trec.rglru_scan(a, b)
    h_ref, run = torch.zeros(2, 8), torch.ones(2, 8)
    for t in range(seq):
        h_ref = a[:, t] * h_ref + b[:, t]
        run = run * a[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), h_ref.numpy(),
                                   err_msg=f"h at {t}", **RG_TOL)
        np.testing.assert_allclose(a_cum[:, t].numpy(), run.numpy(),
                                   err_msg=f"a_cum at {t}", **RG_TOL)


def test_rglru_state_is_updated_in_place():
    state = _as_torch(_rg_state(7))
    ids = {k: v.data_ptr() for k, v in state.items()}
    before = {k: v.clone() for k, v in state.items()}
    _, out = _rg_torch("chunk_prefill", _rg_x(4), state)
    assert out is state
    for k in state:
        assert state[k].data_ptr() == ids[k]
        assert not torch.equal(state[k], before[k]), k
