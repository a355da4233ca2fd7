"""The traffic generator: the same work for every seed, in another order,
deterministic per seed, within the stated ranges."""
import json
from collections import Counter
from pathlib import Path

import pytest

from portbench import generate

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
WAVES = sorted(p.stem for p in TRAFFIC.glob("*.json")
               if json.loads(p.read_text())["kind"] == "waves")


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", WAVES)
def test_wave_is_deterministic_per_seed(name):
    tr = _mix(name)
    a = generate.wave(tr, 1000, 2**31 + 7, 3)
    b = generate.wave(tr, 1000, 2**31 + 7, 3)
    c = generate.wave(tr, 1000, 2**31 + 8, 3)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", WAVES)
def test_every_seed_and_wave_does_the_same_work(name):
    tr = _mix(name)
    sizes = {(s, k): Counter(len(p) for p, _ in generate.wave(tr, 50, s, k))
             for s in (1, 2**33 + 5) for k in (0, 1)}
    outs = {(s, k): Counter(n for _, n in generate.wave(tr, 50, s, k))
            for s in (1, 2**33 + 5) for k in (0, 1)}
    assert len({tuple(sorted(c.items())) for c in sizes.values()}) == 1
    assert len({tuple(sorted(c.items())) for c in outs.values()}) == 1
    orders = {s: [(len(p), n) for p, n in generate.wave(tr, 50, s, 0)]
              for s in (1, 2, 3)}
    assert orders[1] == orders[2] == orders[3]
    later = [(len(p), n) for p, n in generate.wave(tr, 50, 1, 1)]
    assert later != orders[1]


@pytest.mark.parametrize("name", WAVES)
def test_lengths_lie_in_their_ranges_and_fit_the_engine(name):
    tr = _mix(name)
    reqs = generate.wave(tr, 97, 12345, 0)
    assert len(reqs) == tr["requests"]
    for prompt, new in reqs:
        assert tr["prompt"]["lo"] <= len(prompt) <= tr["prompt"]["hi"]
        assert tr["output"]["lo"] <= new <= tr["output"]["hi"]
        assert all(0 <= t < 97 for t in prompt)
    stats = generate.wave_stats(tr)
    assert stats["prompt_tokens"] == sum(len(p) for p, _ in reqs)
    for cfg in (Path(__file__).resolve().parents[1] / "configs").glob("*.json"):
        engine = {**json.loads(cfg.read_text())["serve"]["engine"],
                  **tr.get("engine", {})}
        assert (stats["longest_prompt"] + stats["longest_output"] + 1
                <= engine["max_len"])


def test_quantiles_are_the_distribution_midpoints():
    assert generate.quantiles({"dist": "uniform", "lo": 0, "hi": 100}, 4) == \
        [12, 38, 62, 88]
    lu = generate.quantiles({"dist": "loguniform", "lo": 1, "hi": 10000}, 4)
    assert lu == [3, 32, 316, 3162]


def test_warmup_runs_every_chunk_size():
    eng = {"chunk_max": 512, "drain_every": 8}
    reqs = generate.warmup_wave({}, eng, 100, 5)
    assert [len(p) for p, _ in reqs] == [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]
    assert all(n == 25 for _, n in reqs)


def test_train_batches_are_seeded_and_shifted():
    torch = pytest.importorskip("torch")
    tr = {"batch": 3, "seq": 16}
    a = generate.train_batch(tr, 50, 2**32 + 1, 0, torch.device("cpu"))
    b = generate.train_batch(tr, 50, 2**32 + 1, 0, torch.device("cpu"))
    c = generate.train_batch(tr, 50, 2**32 + 1, 1, torch.device("cpu"))
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 3
