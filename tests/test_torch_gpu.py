"""The CUDA flash-attention kernel against its plain version, on the card.

Run on a machine with an NVIDIA card (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: the kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

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
