"""Whole runs at small sizes on the CPU: with no card run.py refuses; a
sound run is correct; and each fault a cell can have, planted under the
timed path, makes ``correct`` come out false. The harness's look for a
card is skipped here (``cell.run`` on the CPU); everything after it runs."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.tests.small import SMALL, run_small
from portbench.harness import env


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lc-moe-train-T2048", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(env.ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_run_py_fails_with_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, there is no program to measure: no result."""
    shutil.copy(env.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(env.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and _no_result(out)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    result = run_small(name, trace=trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    json.dumps(result)
    if trace:
        assert "breakdown" in result
    else:
        assert "setup_s" in result["metrics"]


def _adamw_noop(monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    real = TrainStep.backward

    def backward(self, batch, class_weights=None):
        half = batch["label"].shape[0] // 2
        return real(self, {k: v[:half] for k, v in batch.items()},
                    class_weights)

    monkeypatch.setattr(TrainStep, "backward", backward)


def _answer_altered(monkeypatch):
    """Each row's answer replaced by its neighbour's, where produced."""
    from multimodal_eeg_fmri_tpu_torch.serving import EnsemblePredictor

    real = EnsemblePredictor.__call__

    def call(self, **inputs):
        out = real(self, **inputs)
        return np.roll(out, 1, axis=0) if len(out) > 1 else 1.0 - out

    monkeypatch.setattr(EnsemblePredictor, "__call__", call)


def _half_members(monkeypatch):
    """Half of the ensemble left out, the mean taken over the rest."""
    from multimodal_eeg_fmri_tpu_torch.serving import _EnsembleNet

    real = _EnsembleNet.member_logits

    def member_logits(self, inputs):
        logits = real(self, inputs)
        return logits[: max(1, logits.shape[0] // 2)]

    monkeypatch.setattr(_EnsembleNet, "member_logits", member_logits)


FAULTS = [("lc-moe-train-T2048", _adamw_noop),
          ("lc-moe-train-T2048", _half_batch),
          ("mm-train-T512-b256", _adamw_noop),
          ("mm-train-T512-b256", _half_batch),
          ("mm-serve-ensemble-T512", _answer_altered),
          ("mm-serve-ensemble-T512", _half_members)]


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run_small(name)
    assert not result["correct"], result["checks"]
