"""The port's shared layers against ``repro.models.layers`` in f32: norms,
rotary embeddings and MLPs on the same numpy inputs and weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    base = dict(name="t", family="dense", source="test", n_layers=1,
                d_model=48, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                vocab_size=32, compute_dtype="float32")
    base.update(kw)
    return JaxConfig(**base), ModelConfig(**base)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(norm_type="rmsnorm"),
                                dict(norm_type="rmsnorm", gemma_norm=True),
                                dict(norm_type="layernorm")],
                         ids=["rms", "gemma_rms", "layernorm"])
def test_apply_norm_matches_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    x = _rand(2, 5, 48) * 3.0 + 0.5
    p = {"scale": _rand(48, seed=1) * 0.1 + (0.0 if jcfg.gemma_norm else 1.0)}
    if jcfg.norm_type == "layernorm":
        p["bias"] = _rand(48, seed=2) * 0.1
    ref = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        jnp.asarray(x))
    out = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                        torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    jcfg, tcfg = _cfgs(rope_fraction=fraction)
    x = _rand(2, 7, 4, 16)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    out = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mlp_type,act", [("glu", "silu"), ("glu", "gelu"),
                                          ("dense", "gelu")])
def test_apply_mlp_matches_jax(mlp_type, act):
    """GeGLU uses the tanh-approximate GELU on both sides."""
    jcfg, tcfg = _cfgs(mlp_type=mlp_type, act=act)
    x = _rand(2, 5, 48)
    p = {"w_up": _rand(48, 96, seed=1) * 0.2,
         "w_down": _rand(96, 48, seed=2) * 0.2}
    if mlp_type == "glu":
        p["w_gate"] = _rand(48, 96, seed=3) * 0.2
    ref = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                       jnp.asarray(x))
    out = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                       torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
