"""The control: the plain reference in float8 in the program's place is
not correct.  On a card at each cell's own size, three seeds, against the
cell's own limits (slow: a whole run and the control a seed).  On the CPU
at the smoke sizes, against the smoke cells' limits (set by the same rule
from a dozen smoke seeds), for the serving cells: at two layers of 64
channels the training control's float8 steps read no farther from float32
than the program's bfloat16 ones, so training's control is read on the
card alone.""" 
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from portbench import check, control, run, spec  # noqa: E402
from conftest import ROOT  # noqa: E402


@pytest.mark.parametrize("cell", ["granite-smoke.serve", "rwkv6-smoke.serve"])
def test_control_fails_on_the_cpu(bench_dir, cell):
    out = run.execute(cell, 2**31 + 21, 0.01, False, device="cpu",
                      root=bench_dir, base=bench_dir, keep_ctx=True)
    assert out["correct"]
    ctl = control.control_readings(out, torch.device("cpu"))
    ok, _ = check.judge(ctl, out["_ctx"].limits)
    assert not ok, ctl


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda, cell, tmp_path):
    seeds = ["3100000001", "3100000002", "3100000003"]
    out = tmp_path / "control.jsonl"
    subprocess.run([sys.executable, str(ROOT / "portbench" / "control.py"),
                    "--workload", cell, "--seconds", "1", "--out", str(out),
                    "--seeds", *seeds], check=True, cwd=ROOT, timeout=1800)
    limits = spec.limits(cell)["numbers"]
    for line in out.read_text().splitlines():
        row = json.loads(line)
        assert row["correct"], row
        assert not check.judge(row["control"], limits)[0], row
