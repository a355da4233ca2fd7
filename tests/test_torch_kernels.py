"""The port's flash attention against the JAX package's Pallas kernel.

On CPU the port's ``flash_attention`` runs its plain version; it is held
against ``repro.kernels.ops.flash_attention(..., interpret=True)`` on the
same numpy inputs at ``tests/test_kernels.py``'s bounds (2e-5 in f32, 2e-2
in bf16).  The CUDA kernel itself is checked on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models.attention import attention_core  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, dtype)
    "mqa": (2, 256, 256, 4, 1, 64, 64, True, 0, "float32"),
    "gqa_4to1": (2, 256, 256, 8, 2, 32, 32, True, 0, "float32"),
    "q_offset": (1, 128, 384, 2, 2, 64, 64, True, 0, "float32"),
    "window": (1, 256, 256, 2, 2, 64, 64, True, 128, "float32"),
    "bidirectional": (1, 128, 128, 2, 2, 64, 64, False, 0, "float32"),
    "d256_bf16": (1, 384, 384, 2, 2, 256, 256, True, 0, "bfloat16"),
    "d96_dv64": (1, 128, 128, 2, 2, 96, 64, True, 0, "float32"),
    "ragged_200": (1, 200, 200, 2, 1, 64, 64, True, 0, "float32"),
    "ragged_100_300": (1, 100, 300, 2, 2, 64, 64, True, 48, "float32"),
}


def _inputs(B, Sq, Skv, Hq, Hkv, D, Dv, seed=0, residual=False):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv))]
    if residual:
        arrs.append(rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32))
    return arrs


def _pair(arrs, dtype):
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("name", list(CASES))
def test_flash_plain_matches_jax_kernel(name):
    B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, dtype = CASES[name]
    q_offset = Skv - Sq if causal else 0
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(B, Sq, Skv, Hq, Hkv, D, Dv),
                                       dtype)
    ref = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               q_offset=q_offset, interpret=True)
    before = fa.launches
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset)
    assert fa.launches == before  # a CPU tensor never launches the kernel
    assert out.dtype == tq.dtype and out.shape == (B, Sq, Hq, Dv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("padded", [False, True])
def test_flash_epilogue_matches_jax_kernel(padded):
    """out * out_scale + residual, fused; Sq = 100 is off the tile grid."""
    S = 100 if padded else 128
    (jq, jk, jv, jr), (tq, tk, tv, tr) = _pair(
        _inputs(1, S, S, 2, 2, 64, 64, seed=6, residual=True), "float32")
    ref = jops.flash_attention(jq, jk, jv, causal=True, out_scale=0.5,
                               residual=jr, interpret=True)
    out = fa.flash_attention(tq, tk, tv, causal=True, out_scale=0.5,
                             residual=tr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


@pytest.mark.parametrize("G,window", [(1, 0), (4, 0), (2, 40)])
def test_flash_plain_equals_attention_core_on_contiguous_positions(G, window):
    """The premise of the prefill wiring: with pos_q = pos_k = arange(S) the
    flash function is ``attention_core``'s function (f32, 1e-5)."""
    B, S, Hkv, D = 2, 96, 2, 32
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(B, S, S, Hkv * G, Hkv, D, D, seed=G + window))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    core = attention_core(q, k, v, pos, pos, causal=True, window=window)
    flash = kops.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(flash.numpy(), core.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_row_without_keys_outputs_zero():
    """A row whose window holds no key (pos_q past Skv + window) outputs 0,
    as the kernel's l == 0 rule does."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 8, 2, 2, 16, 16))
    out = fa.flash_attention(q, k, v, causal=True, window=2, q_offset=20)
    assert torch.equal(out, torch.zeros_like(out))


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16, 16))
    with pytest.raises(ValueError):  # non-contiguous
        fa.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):  # mixed dtypes
        fa.flash_attention(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError):  # Dv outside the compiled set
        fa.flash_attention(q, k, torch.zeros(1, 8, 1, 24))
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        fa.flash_attention(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError):  # residual of the wrong shape
        fa.flash_attention(q, k, v, residual=torch.zeros(1, 8, 2, 8))
    # bf16 takes the tensor-core body's 16-byte loads: D % 16 and alignment
    b = torch.zeros(1 + 8 * 2 * 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(*[b[1:].view(1, 8, 2, 16)] * 3)
    qk = torch.zeros(1, 8, 2, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qk, qk, torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16))
