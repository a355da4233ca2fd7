"""The port's serving engines against the JAX engines on the same weights.

gemma-2b smoke params (f32 compute) are drawn by the JAX package and carried
across with ``repro_torch.bridge``.  Over ``tests/test_serving.py``'s ragged
trace and its ``_paged`` settings, the port's ``PagedServingEngine`` and
``ContinuousBatcher`` must emit exactly the JAX engines' greedy tokens, with
the same host-sync and decode-tick counts.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gemma_2b as jax_gemma  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import gemma_2b as torch_gemma  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402

PAGED = dict(n_slots=3, max_len=64, page_size=8, chunk_max=8, drain_every=4)
LENS = [3, 9, 5, 13, 4, 11, 6]


def _trace(mk, seed=3):
    """test_serving.py::_ragged_trace: mixed prompt lengths, staggered
    arrivals, ragged max_new -- interleaved admissions, completions and slot
    reuse."""
    rng = np.random.RandomState(seed)
    return [mk(rid=i, prompt=rng.randint(0, 512, LENS[i]).tolist(),
               max_new=3 + (i % 4) * 2, arrival=2 * i)
            for i in range(len(LENS))]


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jax_gemma.smoke().scaled(compute_dtype="float32")
    tcfg = torch_gemma.smoke().scaled(compute_dtype="float32")
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = LanguageModel(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


@functools.lru_cache(maxsize=None)
def _jax_paged_run():
    jmodel, jparams, _, _ = _models()
    reqs = _trace(jserve.Request)
    eng = jserve.PagedServingEngine(jmodel, jparams, dtype=jnp.float32, **PAGED)
    stats = eng.run(reqs)
    return [r.out for r in reqs], stats


def test_paged_engine_matches_jax_engine():
    _, _, tmodel, tparams = _models()
    jax_out, jstats = _jax_paged_run()
    reqs = _trace(tserve.Request)
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


def test_continuous_batcher_matches_jax_batcher():
    jmodel, jparams, tmodel, tparams = _models()
    jreqs = _trace(jserve.Request)
    jstats = jserve.ContinuousBatcher(jmodel, jparams, n_slots=3, max_len=64,
                                      enc_len=0).run(jreqs)
    reqs = _trace(tserve.Request)
    stats = tserve.ContinuousBatcher(tmodel, tparams, n_slots=3,
                                     max_len=64).run(reqs)
    jax_paged_out, _ = _jax_paged_run()
    for r, jr, pr in zip(reqs, jreqs, jax_paged_out):
        assert r.done and not r.rejected
        assert r.out == jr.out == pr, (r.rid, r.out, jr.out, pr)
    for key in ("tokens", "ticks", "host_syncs"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])


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
