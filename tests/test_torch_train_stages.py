"""Training stages as assets on the port (examples/torch_train_lm.py's
graph) at smoke size on the CPU: each stage resumes from the checkpoint
the one before wrote, an injected failure is retried, the checkpoint's
bytes and seconds reach telemetry, and a second run is all cache hits."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from examples.torch_train_lm import stage_graph  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (CostModel, DynamicClientFactory,  # noqa: E402
                              MessageReader, Objective, RunCoordinator,
                              default_catalog)
from repro_torch.launch.train import train  # noqa: E402


def test_train_reports_its_checkpoint(tmp_path):
    kw = dict(arch="gemma-2b", global_batch=2, seq_len=16, log_every=1,
              ckpt_dir=str(tmp_path), device="cpu")
    first = train(steps=2, **kw)["checkpoint"]
    assert first["resumed_step"] == 0 and first["restore_s"] == 0.0
    step_dir = tmp_path / "step_00000002"
    assert first["bytes"] == sum(os.path.getsize(step_dir / f)
                                 for f in os.listdir(step_dir)) > 0
    assert first["bytes"] == CheckpointManager(str(tmp_path)).nbytes(2)
    again = train(steps=3, **kw)["checkpoint"]
    assert again["resumed_step"] == 2 and again["restore_s"] > 0
    assert again["save_s"] > 0 and again["bytes"] > 0
    assert train(steps=3, **{**kw, "ckpt_dir": None})["checkpoint"] == {
        "resumed_step": 0, "restore_s": 0.0, "save_s": 0.0, "bytes": 0}


def test_stages_resume_across_checkpoints(tmp_path):
    reader = MessageReader()
    coord = RunCoordinator(
        stage_graph("h2o-danube-1.8b", 2, 3, str(tmp_path), device="cpu"),
        DynamicClientFactory(default_catalog(), CostModel(),
                             Objective.balanced(), sim_seed=2),
        reader=reader)
    report = coord.materialize(["stage1"], run_id="train-stages")
    assert report.ok
    assert sum(len(r.attempts) - 1 for r in report.records) >= 1
    losses = []
    for i in range(2):
        out = coord.store.get(f"stage{i}", "__all__")
        ck = reader.events(kind="CHECKPOINT", asset=f"stage{i}")[-1].payload
        assert out["resumed_step"] == ck["resumed_step"] == 3 * i
        assert out["steps"] == 3 * (i + 1) and ck["bytes"] > 0
        losses += out["losses"]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    again = coord.materialize(["stage1"], run_id="train-stages-2")
    assert all(r.cached for r in again.records)
    assert len(reader.events(kind="CHECKPOINT")) == 2
