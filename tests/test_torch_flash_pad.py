"""The wgmma body at head dims that are not multiples of 64, on the CPU.

At (D, Dv) = (80, 80) (h2o-danube-1.8b) and (96, 64) (minicpm3-4b's MLA)
the kernel keeps Q, K and V in whole 64-column boxes: TMA zero-fills the
columns past the head dim, S = Q K^T runs D / 16 k-steps at the real
D's scale, P V runs at the padded Dv (128 at Dv 80), and only the real
columns are stored.  Here that computation is emulated in plain PyTorch --
q and k zero-padded to the padded D, v to the padded Dv,
``flash_attention_split_plain`` run on the wgmma body's split plan, the
result cut to Dv -- and held against the JAX package's Pallas kernel in
interpret mode on the same numpy inputs, in f32 at 2e-5 (the bound of
``tests/test_torch_kernels.py``).  The CUDA kernel itself is checked on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)

PAD_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, residual)
    # danube's GQA at D 80 with a window; Skv not a multiple of 64
    "d80_window_ragged": (1, 200, 200, 4, 2, 80, 80, True, 48, 0, False),
    "d80_window_q_offset": (1, 100, 300, 4, 2, 80, 80, True, 96, 200, False),
    # the epilogue out * out_scale + residual at D 80
    "d80_residual": (2, 130, 130, 4, 4, 80, 80, True, 0, 0, True),
    # minicpm3's MLA heads, causal; then an Sq that is not a multiple of 64
    "d96_dv64_causal": (1, 192, 192, 4, 4, 96, 64, True, 0, 0, False),
    "d96_dv64_ragged": (2, 150, 150, 2, 2, 96, 64, True, 0, 0, False),
}


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, D, Dv, *_rest, residual = case
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)]
    if residual:
        shapes.append((B, Sq, Hq, Dv))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _kw(case):
    *_, causal, window, q_offset, residual = case
    return dict(causal=causal, window=window, q_offset=q_offset,
                out_scale=0.5 if residual else 1.0)


def padded_wgmma(q, k, v, *, residual=None, out_scale=1.0, block_k=64,
                 **kw):
    """The wgmma body's computation at a padded head dim: zero columns up to
    whole 64-column boxes, the real D's scale, the split plan at
    ``block_k``; returns the real Dv columns and the padded ones."""
    D, Dv = q.shape[-1], v.shape[-1]
    Dp, Dvp = fa.wgmma_widths(D, Dv)
    qp, kp = (F.pad(t, (0, Dp - D)) for t in (q, k))
    vp = F.pad(v, (0, Dvp - Dv))
    res = None if residual is None else F.pad(residual, (0, Dvp - Dv))
    out = fa.flash_attention_split_plain(
        qp, kp, vp, scale=D ** -0.5,
        out_scale=out_scale, residual=res, block_k=block_k, **kw)
    return out[..., :Dv], out[..., Dv:]


def _jax_ref(arrs, kw):
    jx = [jnp.asarray(a) for a in arrs]
    return np.asarray(jops.flash_attention(
        jx[0], jx[1], jx[2], residual=jx[3] if len(jx) > 3 else None,
        interpret=True, **kw))


@pytest.mark.parametrize("block_k", fa.WGMMA_BLOCK_K)
@pytest.mark.parametrize("name", list(PAD_CASES))
def test_padded_computation_matches_jax_kernel(name, block_k):
    case = PAD_CASES[name]
    arrs = _inputs(case, seed=block_k)
    kw = _kw(case)
    B, Sq, Skv, Hq = case[:4]
    plan = fa.split_plan(B, Sq, Skv, Hq, *case[7:10], block_k=block_k)
    assert plan.merges, "the case must split at least one unit"
    tq, tk, tv, *tr = (torch.from_numpy(a) for a in arrs)
    out, pad = padded_wgmma(tq, tk, tv, residual=tr[0] if tr else None,
                            block_k=block_k, **kw)
    # the padded product's extra columns: P times zero-filled V, plus the
    # zero-padded residual, are exactly 0 before the kernel drops them
    assert torch.equal(pad, torch.zeros_like(pad))
    np.testing.assert_allclose(out.numpy(), _jax_ref(arrs, kw), **F32)

