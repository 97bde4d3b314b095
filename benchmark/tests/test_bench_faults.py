"""Runs of the harness with the timed path broken underneath: each must come
out not correct. The harness's look for a card is skipped (the runner is
called directly, on the CPU, at the small sizes of `small_bench`)."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import polaris_tpu_torch as P
from polaris_tpu_torch.render import integrator, trainer
from harness import runner, scenes

SEED = 2**31 + 977


def run(bd, cell):
    torch.set_num_threads(2)
    return runner.run(cell, SEED, 0.5, False, device="cpu", bench_dir=bd)


@pytest.fixture
def terrain_bench(small_bench, tmp_path, monkeypatch):
    """`small_bench` with 64x64 frames, so that a terrain frame check
    compares as many pixels as the cell's does, and the compiled terrain
    kept under the test's own directory."""
    path = os.path.join(small_bench, "traffic", "frames_1024sq_16spp.json")
    with open(path) as f:
        d = json.load(f)
    d.update(width=64, height=64)
    with open(path, "w") as f:
        json.dump(d, f)
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path / "cache"))
    return small_bench


def test_sound_runs_are_correct(small_bench):
    assert run(small_bench, "sphere-frame")["correct"]
    assert run(small_bench, "sphere-grad")["correct"]


def test_sound_terrain_run_is_correct(terrain_bench):
    out = run(terrain_bench, "terrain819k-frame")
    assert out["correct"], out["checks"]


@pytest.fixture
def frame_fault(monkeypatch):
    real = integrator.TorchRenderer.render_u8

    def install(kind):
        kept = {}

        def broken(self, opt, camera=None):
            if kind == "state_unchanged":  # every frame is the first one rendered
                if "img" not in kept:
                    kept["img"] = real(self, opt, camera)
                return kept["img"].copy()
            if kind == "half_batch":  # half the samples, the mean over the rest
                return real(self, replace(opt, spp=opt.spp // 2), camera)
            img = real(self, opt, camera)  # an answer altered where it is produced
            return np.clip(img.astype(np.int64) + 3, 0, 255).astype(np.uint8)

        monkeypatch.setattr(integrator.TorchRenderer, "render_u8", broken)

    return install


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_frame_faults_fail(small_bench, frame_fault, kind):
    frame_fault(kind)
    out = run(small_bench, "sphere-frame")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_terrain_frame_faults_fail(terrain_bench, frame_fault, kind):
    frame_fault(kind)
    out = run(terrain_bench, "terrain819k-frame")
    assert not out["correct"], out["checks"]


@pytest.fixture
def step_fault(monkeypatch):
    real = trainer.Trainer.step

    def install(kind):
        def broken(self, target):
            fault = kind.removeprefix("window_")
            if fault != kind and self.step_idx < 3:  # the set-up's steps sound, the window's broken
                return real(self, target)
            if fault == "state_unchanged":  # the loss, and no update
                loss, _, _ = self.renderer.loss_and_grad(
                    replace(self.opt, seed=self.opt.seed + self.step_idx), target, self.camera
                )
                self.step_idx += 1
                return loss
            if fault == "half_batch":  # half the samples of the batch
                full = self.opt
                self.opt = replace(full, spp=max(1, full.spp // 2))
                try:
                    return real(self, target)
                finally:
                    self.opt = full
            return real(self, target) * 1.01  # the loss altered where it is produced

        monkeypatch.setattr(trainer.Trainer, "step", broken)

    return install


@pytest.mark.parametrize("kind", [
    "state_unchanged", "half_batch", "answer_altered",
    "window_state_unchanged", "window_half_batch", "window_answer_altered",
])
def test_step_faults_fail(small_bench, step_fault, kind):
    step_fault(kind)
    out = run(small_bench, "sphere-grad")
    assert not out["correct"], out["checks"]


def test_public_names_the_faults_patch():
    assert P.TorchRenderer is integrator.TorchRenderer and P.Trainer is trainer.Trainer
