"""The port's serving engines against the JAX engines on the same weights.

gemma-2b, rwkv6-1.6b, h2o-danube-1.8b, recurrentgemma-9b, minicpm3-4b and
granite-moe-1b-a400m smoke params (f32 compute) are drawn by the JAX
package and carried across with
``repro_torch.bridge``.  Over
``tests/test_serving.py``'s ragged trace and its ``_paged`` settings, the
port's ``PagedServingEngine`` and ``ContinuousBatcher`` must emit exactly the
JAX engines' greedy tokens, with the same host-sync and decode-tick counts.
rwkv6, danube and recurrentgemma have no page pool leaf: their per-slot
states (WKV, SWA rings, RG-LRU ``h`` and conv window) go through the paged
cache's gather, scatter and reset, and the dense batcher's slot writes, as
dense leaves; so do minicpm3-4b's MLA latents.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402

PAGED = dict(n_slots=3, max_len=64, page_size=8, chunk_max=8, drain_every=4)
LENS = [3, 9, 5, 13, 4, 11, 6]


def _trace(mk, vocab=512, seed=3):
    """test_serving.py::_ragged_trace: mixed prompt lengths, staggered
    arrivals, ragged max_new -- interleaved admissions, completions and slot
    reuse."""
    rng = np.random.RandomState(seed)
    return [mk(rid=i, prompt=rng.randint(0, vocab, LENS[i]).tolist(),
               max_new=3 + (i % 4) * 2, arrival=2 * i)
            for i in range(len(LENS))]


@functools.lru_cache(maxsize=None)
def _models(arch="gemma-2b"):
    name = arch.replace("-", "_").replace(".", "_")
    jcfg = importlib.import_module(f"repro.configs.{name}").smoke()
    tcfg = importlib.import_module(f"repro_torch.configs.{name}").smoke()
    jcfg, tcfg = (c.scaled(compute_dtype="float32") for c in (jcfg, tcfg))
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if arch == "recurrentgemma-9b":
        # JAX inits the RG-LRU conv to zeros, which zeros every RG-LRU
        # output and state: draw it (0.5 x a seeded normal) so the states
        # the engines carry are nonzero
        rng = np.random.RandomState(0)
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(
                0.5 * rng.standard_normal(a.shape), a.dtype)
            if path[-1].key == "conv_w" else a, jparams)
    tmodel = LanguageModel(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


@functools.lru_cache(maxsize=None)
def _jax_paged_run(arch="gemma-2b"):
    jmodel, jparams, _, _ = _models(arch)
    reqs = _trace(jserve.Request, jmodel.cfg.vocab_size)
    eng = jserve.PagedServingEngine(jmodel, jparams, dtype=jnp.float32, **PAGED)
    stats = eng.run(reqs)
    return [r.out for r in reqs], stats


def _check_paged_engine(arch):
    _, _, tmodel, tparams = _models(arch)
    jax_out, jstats = _jax_paged_run(arch)
    reqs = _trace(tserve.Request, tmodel.cfg.vocab_size)
    eng = tserve.PagedServingEngine(tmodel, tparams, dtype=torch.float32,
                                    **PAGED)
    stats = eng.run(reqs)
    for r, ref in zip(reqs, jax_out):
        assert not r.rejected and r.done
        assert r.out == ref, (r.rid, r.out, ref)
    assert stats["tokens"] == sum(len(o) for o in jax_out)
    assert eng.kv.stats().pages_in_use == 0  # every page returned
    assert all(s is None for s in eng.slot_req)
    for key in ("host_syncs", "decode_ticks", "drains", "prefill_chunks",
                "ticks"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])
    return stats


def _check_continuous_batcher(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    vocab = tmodel.cfg.vocab_size
    jreqs = _trace(jserve.Request, vocab)
    jstats = jserve.ContinuousBatcher(jmodel, jparams, n_slots=3, max_len=64,
                                      enc_len=0).run(jreqs)
    reqs = _trace(tserve.Request, vocab)
    stats = tserve.ContinuousBatcher(tmodel, tparams, n_slots=3,
                                     max_len=64).run(reqs)
    jax_paged_out, _ = _jax_paged_run(arch)
    for r, jr, pr in zip(reqs, jreqs, jax_paged_out):
        assert r.done and not r.rejected
        assert r.out == jr.out == pr, (r.rid, r.out, jr.out, pr)
    for key in ("tokens", "ticks", "host_syncs"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])


def test_paged_engine_matches_jax_engine():
    _check_paged_engine("gemma-2b")


def test_continuous_batcher_matches_jax_batcher():
    _check_continuous_batcher("gemma-2b")


def test_rwkv_paged_engine_matches_jax_engine():
    """Pure recurrence: no page pool leaf, so pages are only booked; padded
    prefill-group members scan zero state and are never written back."""
    before = ls.launches
    stats = _check_paged_engine("rwkv6-1.6b")
    assert ls.launches == before  # the CPU path never launches the kernel
    assert stats["prefill_chunks"] > 0


def test_rwkv_continuous_batcher_matches_jax_batcher():
    _check_continuous_batcher("rwkv6-1.6b")


def test_rwkv_slots_recycled_match_jax():
    """test_serving.py::test_slots_recycled on both packages: 5 requests
    through 2 dense slots, the same greedy tokens and counters."""
    jmodel, jparams, tmodel, tparams = _models("rwkv6-1.6b")

    def trace(mk):
        rng = np.random.RandomState(1)
        return [mk(rid=i, prompt=rng.randint(0, 256, 3).tolist(), max_new=4)
                for i in range(5)]

    jreqs = trace(jserve.Request)
    jstats = jserve.ContinuousBatcher(jmodel, jparams, n_slots=2, max_len=32,
                                      enc_len=0).run(jreqs)
    reqs = trace(tserve.Request)
    stats = tserve.ContinuousBatcher(tmodel, tparams, n_slots=2,
                                     max_len=32).run(reqs)
    assert stats["requests"] == 5 and stats["tokens"] == 20
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for key in ("tokens", "ticks", "host_syncs"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_swa_family_paged_engine_matches_jax_engine(arch):
    """No full-attention layer: no page pool leaf, every leaf slot-dense
    (SWA rings that wrap past the 16-token smoke window; RG-LRU states)."""
    stats = _check_paged_engine(arch)
    assert stats["prefill_chunks"] > 0


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_swa_family_continuous_batcher_matches_jax_batcher(arch):
    _check_continuous_batcher(arch)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-1b-a400m"])
def test_mla_moe_paged_engine_matches_jax_engine(arch):
    """minicpm3-4b: every attention layer is MLA, so the cache has no page
    pool leaf, only slot-dense latents; granite-moe-1b-a400m: GQA page
    pools, and the routed experts in every layer."""
    stats = _check_paged_engine(arch)
    assert stats["prefill_chunks"] > 0


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-1b-a400m"])
def test_mla_moe_continuous_batcher_matches_jax_batcher(arch):
    _check_continuous_batcher(arch)


def test_paged_engine_recycles_pages_under_pressure():
    """Pool sized for two of the three big requests at once: admission scans
    past the blocked head, every request completes, every page comes back."""
    _, _, tmodel, tparams = _models()
    rng = np.random.RandomState(5)
    big = [tserve.Request(rid=i, prompt=rng.randint(0, 512, 40).tolist(),
                          max_new=8) for i in range(3)]
    small = tserve.Request(rid=99, prompt=rng.randint(0, 512, 3).tolist(),
                           max_new=3)
    eng = tserve.PagedServingEngine(tmodel, tparams, dtype=torch.float32,
                                    **dict(PAGED, n_slots=2))
    eng.run(big + [small])
    assert all(r.done and not r.rejected for r in big + [small])
    assert [len(r.out) for r in big + [small]] == [8, 8, 8, 3]
    assert eng.kv.stats().pages_in_use == 0
