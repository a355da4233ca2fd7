"""The check catches a broken timed path: each fault a cell can have,
planted under a whole run (the look for a card aside), turns ``correct``
false.  On one card no cell exchanges anything between chips."""
import pytest

pytest.importorskip("torch")

from portbench import faults, run  # noqa: E402

CELLS = ["granite-smoke.serve", "rwkv6-smoke.serve", "granite-smoke.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(bench_dir, cell):
    out = run.execute(cell, 2**31 + 11, 0.01, False, device="cpu",
                      root=bench_dir, base=bench_dir)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(bench_dir, cell, fault):
    with faults.planted(fault):
        out = run.execute(cell, 2**31 + 11, 0.01, False, device="cpu",
                          root=bench_dir, base=bench_dir)
    assert not out["correct"], out["checks"]


def test_faults_are_undone():
    from repro_torch.launch.serve import PagedServingEngine

    before = PagedServingEngine.__dict__["_drain"]
    with faults.planted("token_altered"):
        assert PagedServingEngine.__dict__["_drain"] is not before
    assert PagedServingEngine.__dict__["_drain"] is before
