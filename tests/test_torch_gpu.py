"""The port's CUDA kernels (flash attention, the RWKV-6 WKV scan) against
their plain versions, on the card.

Run on a machine with an NVIDIA card (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: the kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402

GPU_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale, dtype)
    (1, 1000, 1000, 8, 1, 256, 256, True, 0, 0, 1.0, torch.bfloat16),
    (1, 300, 300, 4, 2, 80, 80, True, 64, 0, 1.0, torch.bfloat16),
    (1, 100, 300, 2, 2, 192, 128, True, 0, 200, 1.0, torch.bfloat16),
    (2, 130, 130, 4, 4, 64, 64, False, 0, 0, 0.5, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_flash_kernel_matches_plain_on_gpu(case):
    """The CUDA kernel against its plain version on the card (2e-2 bf16,
    2e-5 f32 -- the f32 kernel sums in another order than the einsum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale, dt = case
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, res = (torch.randn(s, generator=g, device="cuda").to(dt) for s in
                    ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv),
                     (B, Sq, Hq, Dv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              out_scale=out_scale, residual=res)
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


WKV_GPU_CASES = [
    # (B, S, H, N): tests/test_kernels.py's WKV cases, its padded S = 100,
    # the rwkv6-1.6b prefill, a paged chunk round, an odd length
    (1, 64, 2, 16), (2, 128, 2, 32), (1, 128, 4, 64), (2, 96, 2, 16),
    (2, 100, 2, 32), (1, 1000, 32, 64), (8, 64, 32, 64), (1, 97, 32, 64),
]


def _wkv_inputs(B, S, H, N, seed=0):
    """Realistic decays log_w = -exp(w_raw), w_raw in [-6, 0]; nonzero s0."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    w_raw = torch.rand((B, S, H, N), generator=g, device="cuda") * 6.0 - 6.0
    return (randn(B, S, H, N), randn(B, S, H, N), randn(B, S, H, N),
            -torch.exp(w_raw), randn(H, N) * 0.1, randn(B, H, N, N) * 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_kernel_matches_plain_on_gpu(case):
    """The CUDA scan against the chunked plain version: 1e-4 relative to
    max(1, max |plain|) -- the two sum in different orders, the plain one
    through exp of decay differences."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    args = _wkv_inputs(*case)
    before = ls.launches
    y, s_fin = ls.linear_scan(*args)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    y_ref, s_ref = ls.linear_scan_plain(*args)
    assert y.shape == y_ref.shape and s_fin.shape == s_ref.shape
    for out, ref in ((y, y_ref), (s_fin, s_ref)):
        assert bool(torch.isfinite(out).all())
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-4 * scale
