"""The port's dry-run tooling and paper-claim benchmarks against the JAX
package's.

* ``torch_table1_cost``: ``per_cell_table()`` and
  ``headline_claims(n_seeds=16)`` equal to the reference's, exactly, but
  for the simulated makespan share: a speculative twin launched on the
  host's clock makes the reference's own runs differ in the last digits
  (``all-spot`` seed 0: 69936.59047148227 s, then 69936.59050080775 s), so
  that one key is held to ``rtol 1e-6``.
* ``launch/flops.py`` and ``dryrun.model_flops`` / ``active_param_count``
  equal to JAX's for all 10 archs x 4 shapes (rel 1e-12); the three
  analytic tests of ``tests/test_flops_model.py`` on the port; and its
  HLO-band test as ``FlopCounterMode`` over a smoke train step on the CPU
  (the same 0.4-2.5 band).
* ``analysis.roofline`` against JAX's formula with the H100's rates put in
  the reference module's constants.
* A smoke ``run_cell`` on a fake 2 x 2 mesh, in a child process (the fake
  process group is global): argument bytes per rank equal to the bytes
  worked out from ``param_axes`` and the mesh shape, collectives counted,
  the schema keys of ``tests/test_dryrun_artifacts.py``; and
  ``torch_lm_platform_choice.run()`` over that cell.
* ``plan_preview``'s output equal to JAX's.

``repro.launch.dryrun`` forces 512 host devices at import, so JAX's side of
the dry-run functions runs in a child process.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.launch import flops as ref_flops  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.core.platforms import H100_SXM  # noqa: E402
from repro_torch.launch import analysis, dryrun, flops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLANS = [("balanced", 60.0, None, None), ("min_cost", 60.0, None, None),
         ("balanced", 60.0, None, 10.0)]

#: JAX's dry-run functions, run where forcing 512 host devices harms nothing
JAX_SIDE = """
import contextlib, io, json, sys
from repro.configs import SHAPES, get_config, list_configs
from repro.launch import dryrun
out = {"model_flops": {}, "active": {}, "plans": []}
for arch in list_configs():
    cfg = get_config(arch)
    out["active"][arch] = dryrun.active_param_count(cfg)
    for name, shape in SHAPES.items():
        out["model_flops"][f"{arch}/{name}"] = dryrun.model_flops(cfg, shape)
for args in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.plan_preview(*args)
    out["plans"].append(buf.getvalue())
print(json.dumps(out))
"""


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def jax_side():
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(PLANS)],
                       capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ paper claims
def test_table1_and_headline_claims_equal_the_reference():
    from benchmarks import table1_cost as ref
    from benchmarks import torch_table1_cost as port

    assert port.TABLE1 == ref.TABLE1
    assert port.per_cell_table(device="cpu") == ref.per_cell_table()
    got = port.headline_claims(n_seeds=16, device="cpu")
    want = ref.headline_claims(n_seeds=16)
    assert sorted(got) == sorted(want)
    timed = "makespan_improvement_vs_spot_simulated"
    assert {k: v for k, v in got.items() if k != timed} == \
        {k: v for k, v in want.items() if k != timed}
    np.testing.assert_allclose(got[timed], want[timed], rtol=1e-6)


# ----------------------------------------------------------------- flops
def test_flops_equal_jax_for_every_arch_and_shape(jax_side):
    assert list_configs() == sorted(jax_side["active"])
    for arch in list_configs():
        cfg, jcfg = get_config(arch), ref_config(arch)
        assert dryrun.active_param_count(cfg) == jax_side["active"][arch]
        for name, shape in SHAPES.items():
            jshape = REF_SHAPES[name]
            assert (shape.kind, shape.seq_len, shape.global_batch) == \
                (jshape.kind, jshape.seq_len, jshape.global_batch)
            pairs = [
                (flops.step_flops(cfg, shape), ref_flops.step_flops(jcfg, jshape)),
                (flops.step_hbm_bytes(cfg, shape, 256, 8),
                 ref_flops.step_hbm_bytes(jcfg, jshape, 256, 8)),
                (flops.step_hbm_bytes(cfg, shape, 512, 8),
                 ref_flops.step_hbm_bytes(jcfg, jshape, 512, 8)),
                (dryrun.model_flops(cfg, shape),
                 jax_side["model_flops"][f"{arch}/{name}"]),
            ]
            for got, want in pairs:
                assert want > 0
                assert abs(got - want) <= 1e-12 * abs(want), (arch, name)


def _tiny_cfg(cls=ModelConfig):
    return cls(
        name="tiny", family="dense", source="test", n_layers=1, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=512,
        remat="none", compute_dtype="float32", pos_type="rope",
    )


def test_step_flops_scales_linearly_in_tokens():
    cfg = _tiny_cfg()
    f1 = flops.step_flops(cfg, ShapeSpec("a", "train", 128, 2))
    f2 = flops.step_flops(cfg, ShapeSpec("b", "train", 128, 4))
    assert abs(f2 / f1 - 2.0) < 0.05


def test_decode_flops_much_smaller_than_prefill():
    cfg = _tiny_cfg()
    fp = flops.step_flops(cfg, ShapeSpec("p", "prefill", 4096, 8))
    fd = flops.step_flops(cfg, ShapeSpec("d", "decode", 4096, 8))
    assert fd < fp / 100


def test_hbm_decode_dominated_by_weights_and_cache():
    cfg = _tiny_cfg()
    b = flops.step_hbm_bytes(cfg, ShapeSpec("d", "decode", 32768, 128),
                             n_chips=256, tp=16)
    weights = cfg.param_count() * 2 / 16
    assert b > weights  # cache term adds on top
    assert cfg.param_count() == _tiny_cfg(RefModelConfig).param_count()


def test_analytic_flops_within_band_of_a_counted_step():
    """The counterpart of the HLO band test: ``FlopCounterMode`` counts the
    products of one eager train step (forward, backward, optimizer) of the
    1-layer config on the CPU; the analytic count must be within the band
    JAX's test allows (its attention counts S/2, the step runs S)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.train import make_train_step
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, OptConfig

    cfg = _tiny_cfg()
    shape = ShapeSpec("t", "train", 128, 2)
    model = LanguageModel(cfg, device="cpu")
    params = model.init(0)
    opt = AdamW(OptConfig())
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
             for k in ("tokens", "targets")}
    step = make_train_step(model, opt)
    with FlopCounterMode(display=False) as counter:
        step(params, opt.init(params), batch)
    counted = counter.get_total_flops()
    analytic = flops.step_flops(cfg, shape)
    assert counted > 0
    assert 0.4 < counted / analytic < 2.5, (counted, analytic)


# --------------------------------------------------------------- roofline
def test_roofline_is_the_reference_formula_at_h100_rates(monkeypatch):
    monkeypatch.setattr(ref_analysis, "PEAK_FLOPS", H100_SXM.peak_flops)
    monkeypatch.setattr(ref_analysis, "HBM_BW", H100_SXM.hbm_bw)
    monkeypatch.setattr(ref_analysis, "ICI_BW", H100_SXM.link_bw)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    for args in [(3.2e15, 1.1e12, 4.0e9, 5.1e17, 256),
                 (1.0e12, 9.0e11, 1.0e6, 2.0e14, 512),
                 (1.0e9, 1.0e6, 7.5e10, 1.0e11, 256)]:
        assert analysis.roofline(*args) == ref_analysis.roofline(*args)


# --------------------------------------------------------------- run_cell
RUN_CELL = """
import json, sys
from repro_torch.configs.gemma_2b import smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import run_cell
cell = run_cell("gemma-2b", "smoke_train", "32x8", cfg=smoke(),
                shape=ShapeSpec("smoke_train", "train", 32, 4),
                layout=((2, 2), ("data", "model")))
print(json.dumps(cell))
"""


@pytest.fixture(scope="module")
def smoke_cell():
    r = subprocess.run([sys.executable, "-c", RUN_CELL], capture_output=True,
                       text=True, timeout=300, env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _expected_argument_bytes() -> int:
    """Per-rank bytes of params, AdamW's m and v and step, and the batch,
    from ``param_axes``, the rules' mesh axes and the mesh shape alone: each
    dim divided by the sizes of the mesh axes that split it."""
    from repro_torch.configs.gemma_2b import smoke
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_flatten

    sizes = {"data": 2, "model": 2}

    def local(shape, axes):
        n, used = 1, set()
        for dim, name in zip(shape, axes):
            split = 1
            for ax in DEFAULT_RULES.get(name, ()):
                if ax in sizes and ax not in used and dim % (split * sizes[ax]) == 0:
                    split *= sizes[ax]
                    used.add(ax)
            n *= dim // split
        return n

    model = LanguageModel(smoke(), device="meta")
    params = model.init()
    axes = dict(tree_flatten(model.param_axes))
    total = 0
    for key, t in tree_flatten(params):
        n = local(t.shape, axes[key])
        total += n * t.element_size() + 2 * n * 4  # the leaf, then m and v
    total += 4  # AdamW's step count
    total += 3 * local((4, 32), ("batch", "seq_act")) * 4  # tokens, targets, weights
    return total


def test_run_cell_on_a_fake_mesh(smoke_cell):
    c = smoke_cell
    assert c["status"] == "ok", c.get("traceback")
    assert (c["n_chips"], c["kind"], c["mesh"]) == (4, "train", "32x8")
    assert c["memory_analysis"]["argument_size_in_bytes"] == \
        _expected_argument_bytes()
    assert c["fits_hbm"] is True
    assert c["collective_bytes"]["total"] > 0
    assert c["collective_bytes"]["total"] == sum(
        v for k, v in c["collective_bytes"].items() if k != "total")
    assert sum(c["collective_ops"].values()) > 0
    # the schema tests/test_dryrun_artifacts.py reads
    r = c["roofline"]
    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert r[k] >= 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["step_time_s"] == max(r["t_compute_s"], r["t_memory_s"],
                                   r["t_collective_s"])
    assert c["model_flops"] > 0
    assert c["params_total"] >= c["params_active"] > 0
    for k in ("analytic_flops_per_device", "analytic_hbm_bytes_per_device",
              "lower_s", "compile_s"):
        assert c[k] >= 0


def test_run_cell_skips_long_500k_for_full_attention():
    cell = dryrun.run_cell("gemma-2b", "long_500k", "32x8")
    assert cell["status"] == "skipped" and "full-attention" in cell["reason"]
    assert dryrun.mesh_layout("32x8") == ((32, 8), ("data", "model"))
    assert dryrun.mesh_layout("2x32x8") == ((2, 32, 8),
                                            ("pod", "data", "model"))


def test_lm_platform_choice_over_a_smoke_cell(smoke_cell, tmp_path):
    """The port prices the cell through ``repro_torch.core`` at the H100's
    rates, so its hours and dollars are its own; the profile it builds from
    the cell is the reference's."""
    import dataclasses

    from benchmarks import lm_platform_choice as ref
    from benchmarks import torch_lm_platform_choice as port
    from repro_torch.core import default_catalog

    cell = {**smoke_cell, "arch": "gemma-2b-smoke"}
    (tmp_path / "gemma-2b-smoke__train__32x8.json").write_text(
        json.dumps(cell))
    got = port.run(art_dir=str(tmp_path))
    assert list(got) == ["gemma-2b-smoke:smoke_train"]
    row = got["gemma-2b-smoke:smoke_train"]
    assert row["platform"] in default_catalog()
    assert row["duration_h"] >= 0 and row["cost_usd"] >= 0
    assert row["fits_hbm"] is True
    assert dataclasses.asdict(port.profile_from_cell(cell)) == \
        dataclasses.asdict(ref.profile_from_cell(cell))


# ------------------------------------------------------------ plan preview
def test_plan_preview_equals_jax(jax_side):
    for args, want in zip(PLANS, jax_side["plans"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.plan_preview(*args)
        assert buf.getvalue() == want, args


# ------------------------------------------------------------------ utils
def test_utils_helpers_equal_the_reference():
    """``repro_torch.utils``' copies of ``repro.utils``' helpers: the same
    strings and counts; ``tree_bytes`` also sizes meta tensors."""
    import jax.numpy as jnp

    from repro import utils as ref
    from repro_torch import utils

    for n in (0.0, 999.0, 1023.0, 1536.0, 3.5e9, 7.1e15, -2048.0):
        assert utils.human_bytes(n) == ref.human_bytes(n)
        assert utils.human_count(n) == ref.human_count(n)
    for t in (5e-7, 2e-3, 0.5, 42.0, 7200.0):
        assert utils.human_time(t) == ref.human_time(t)
    assert utils.round_up(1000, 128) == ref.round_up(1000, 128) == 1024
    items = list(range(10))
    assert list(utils.chunks(items, 4)) == list(ref.chunks(items, 4))
    shapes = {"a": ((3, 4), "float32"), "b": ((2,), "bfloat16"),
              "c": ((5, 1, 2), "int32")}
    port = {k: torch.zeros(s, dtype=getattr(torch, dt))
            for k, (s, dt) in shapes.items()}
    port["b"] = torch.empty(2, dtype=torch.bfloat16, device="meta")
    jref = {k: jnp.zeros(s, dtype=dt) for k, (s, dt) in shapes.items()}
    assert utils.tree_size(port) == ref.tree_size(jref) == 24
    assert utils.tree_bytes(port) == ref.tree_bytes(jref) == 92
    with utils.Stopwatch() as sw:
        pass
    assert sw.elapsed >= 0
