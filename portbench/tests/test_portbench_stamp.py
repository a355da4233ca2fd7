"""The first-token stamp: one per served request, after its wave began."""
import json
import time

import pytest

pytest.importorskip("torch")

from portbench import generate, serve  # noqa: E402
from portbench.serve import StampedList  # noqa: E402
from portbench.weights import make_weights, nest  # noqa: E402
from conftest import DATA  # noqa: E402


def test_empty_extend_leaves_no_stamp():
    out = StampedList()
    out.extend(iter([]))
    assert out.t_first is None and out == []
    out.extend(x for x in (3, 4))
    t = out.t_first
    assert t is not None and out == [3, 4]
    out.append(5)
    out.extend([6])
    assert out.t_first == t and out == [3, 4, 5, 6]


@pytest.mark.parametrize("name", ["granite-smoke", "rwkv6-smoke"])
def test_every_served_request_has_one_stamp_after_its_wave_began(name):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import PagedServingEngine, Request
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_flatten

    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    model = LanguageModel(get_config(cfg["port"]["name"]).scaled(
        **cfg["port"]["set"]), device="cpu")
    w = make_weights(dict(tree_flatten(model.param_shapes())), cfg["init"], 3,
                     torch.device("cpu"), matrix_dtype="bfloat16",
                     layered=frozenset(cfg["layered"]))
    engine = PagedServingEngine(model, nest(w), **cfg["serve"]["engine"])
    tr = json.loads((DATA / "traffic" / "serve_tiny.json").read_text())
    for k in range(2):
        reqs = serve._requests(generate.wave(tr, 256, 7, k), Request)
        t0 = time.perf_counter()
        engine.run(reqs)
        t1 = time.perf_counter()
        for r in reqs:
            assert len(r.out) == r.max_new
            assert t0 < r.out.t_first < t1
