"""The WKV kernel's chunked body on the CPU.

``linear_scan_chunked_plain`` is the plain twin of the chunked CUDA body:
chunks of 64 steps zero-filled past S, the chunk products and the state
scan (the two-phase state pass), the output pass with off-diagonal tiles
anchored per 16-row sub-chunk and elementwise diagonal tiles, emulated
3xTF32 products.  It is held against ``kernels/ref.py::wkv_ref`` and
against the JAX Pallas kernel in interpret mode at 1e-4, on numpy inputs as
in ``test_torch_recurrent.py``, and at strong decays it must stay finite
and never take an exp of a positive argument.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels.ref import wkv_ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py's WKV bounds

CASES = [
    # (B, S, H, N, JAX chunk): tests/test_kernels.py's WKV_CASES, its padded
    # S = 100 case, and an odd length (one full chunk and a ragged one)
    (1, 64, 2, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 128, 4, 64, 64),
    (2, 96, 2, 16, 32),
    (2, 100, 2, 32, 32),
    (1, 97, 2, 64, 64),
]


def _inputs(B, S, H, N, seed=0, w_hi=0.0):
    """log_w = -exp(w_raw), w_raw in [-6, w_hi]: 0 gives
    tests/test_kernels.py's realistic decays, 3 strong ones (log_w to -20)."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.uniform(-6.0, w_hi, (B, S, H, N))).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    return r, k, v, log_w, u, s0


def _ids(c):
    return "x".join(map(str, c))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunked_twin_matches_ref(case):
    B, S, H, N, _ = case
    arrs = [torch.from_numpy(a) for a in _inputs(B, S, H, N, seed=S)]
    trace = {}
    y, s_fin = ls.linear_scan_chunked_plain(*arrs, trace=trace)
    y_ref, s_ref = wkv_ref(*arrs)
    assert y.shape == (B, S, H, N) and s_fin.shape == (B, H, N, N)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    np.testing.assert_allclose(s_fin.numpy(), s_ref.numpy(), **TOL)
    assert trace["max_exp_arg"] <= 0.0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunked_twin_matches_jax_kernel(case):
    B, S, H, N, chunk = case
    arrs = _inputs(B, S, H, N, seed=S + 1)
    jy, js = jops.linear_scan(*map(jnp.asarray, arrs), chunk=chunk,
                              interpret=True)
    y, s_fin = ls.linear_scan_chunked_plain(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("case", [(1, 200, 2, 64), (2, 97, 2, 32),
                                  (1, 64, 4, 16)], ids=_ids)
def test_chunked_twin_strong_decay_stays_finite(case):
    """w_raw in [-6, 3]: log_w reaches about -20, a chunk's cumulative decay
    about -1000, where e^{-p} would overflow f32.  Every exp argument the
    twin computes is <= 0; outputs are finite and match the per-step
    recurrence within the card's bound, 1e-4 x max(1, max |ref|): a
    difference of two cumulative decays near -1000 carries about 1e-4 of
    absolute error in its exponent, so small outputs miss a 1e-4 rtol."""
    arrs = [torch.from_numpy(a) for a in _inputs(*case, seed=3, w_hi=3.0)]
    assert float(arrs[3].min()) < -19.0
    trace = {}
    y, s_fin = ls.linear_scan_chunked_plain(*arrs, trace=trace)
    assert trace["max_exp_arg"] <= 0.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_fin).all())
    for out, ref in zip((y, s_fin), wkv_ref(*arrs)):
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-4 * scale


def test_state_scan_gives_each_chunks_start_state():
    """The two-phase state pass: the scan over the chunk products yields,
    for every chunk, the recurrence's state at the chunk's first step."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 200, 2, 32, seed=4)]
    trace = {}
    ls.linear_scan_chunked_plain(*arrs, trace=trace)
    starts = trace["start_states"]
    assert starts.shape == (1, 4, 2, 32, 32)
    np.testing.assert_array_equal(starts[:, 0].numpy(), arrs[5].numpy())
    for c in range(1, 4):
        _, s_ref = wkv_ref(*(a[:, :64 * c] for a in arrs[:4]), *arrs[4:])
        np.testing.assert_allclose(starts[:, c].numpy(), s_ref.numpy(), **TOL)


def test_ragged_chunk_is_masked_like_zero_padding():
    """Rows past S read as log_w = 0 and k = 0 (the kernel's zero fill): a
    ragged S gives what the zero-padded full chunk gives, y on the first S
    rows and s_fin alike."""
    arrs = [torch.from_numpy(a) for a in _inputs(2, 97, 2, 16, seed=5)]
    padded = [torch.cat([a, torch.zeros_like(a[:, :31])], 1)
              for a in arrs[:4]] + arrs[4:]
    y, s_fin = ls.linear_scan_chunked_plain(*arrs)
    y_pad, s_pad = ls.linear_scan_chunked_plain(*padded)
    np.testing.assert_array_equal(y.numpy(), y_pad[:, :97].numpy())
    np.testing.assert_array_equal(s_fin.numpy(), s_pad.numpy())


def test_cumsum_never_rises():
    """The in-order cumulative log-decay (both halves of a chunk) never
    rises down a column, so a later row minus an earlier one is <= 0."""
    lw = torch.from_numpy(_inputs(1, 64, 2, 64, seed=6, w_hi=3.0)[3])
    p = ls._cumsum_log2(lw.transpose(1, 2))  # (B, H, C, N)
    assert bool((p[..., 1:, :] <= p[..., :-1, :]).all())
    assert bool((p[..., 0, :] <= 0).all())


def test_three_tf32_products_keep_f32_accuracy():
    """One TF32 pass keeps about 3 digits; the 3xTF32 split keeps f32's
    accuracy on a 64 x 64 x 64 product (what the tolerance needs)."""
    rng = np.random.RandomState(7)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
            for _ in range(2))
    exact = (a.double() @ b.double()).float()
    assert ls._tf32(a).view(torch.int32).bitwise_and(8191).eq(0).all()
    one = ls._tf32(a) @ ls._tf32(b)
    three = ls._mm3(a, b)
    assert float((one - exact).abs().max()) > 1e-3
    assert float((three - exact).abs().max()) < 1e-4


def test_wrapper_takes_only_known_bodies():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 8, 2, 16)]
    with pytest.raises(ValueError):
        ls.linear_scan(*arrs, _body="mma")
    # a CPU tensor runs the plain version whichever body is asked for
    y, _ = ls.linear_scan(*arrs, _body="step")
    y_ref, _ = wkv_ref(*arrs)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    assert ls.scratch_floats(1, 1000, 32, 64) == 16 * 32 * 64 * 65
    assert ls.scratch_floats(8, 64, 32, 64) == 0  # one chunk: no scratch
