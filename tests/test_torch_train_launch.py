"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

``main`` with JAX's flags plus ``--device cpu``: a run with a checkpoint
every 4 steps and a host lost at step 6 restores step 4's checkpoint,
finishes with a finite loss and returns JAX's dict; a second run on the
same directory resumes from its last checkpoint.  Against JAX's launcher
on the same smoke config and flags (no failure), started from JAX's
initial masters (carried over by ``models.convert``; the two packages'
generators draw other numbers from one seed), the first and last losses
agree within 1e-5 relative (the same batches and steps).  The entry
point refuses to run without a card unless asked for the CPU.  The ssm
arch trains through it; the encdec arch, whose batches need ``frames``
that the token pipeline does not make, fails before its first step (JAX's
launcher at its first step).
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
         "--log-every", "100"]


def test_failure_restores_the_last_checkpoint_and_finishes(tmp_path, monkeypatch, capsys):
    restored = []

    class Recording(CheckpointManager):
        def restore(self, template, step=None):
            tree, extra = super().restore(template, step)
            restored.append(extra["step"])
            return tree, extra

    monkeypatch.setattr(train, "CheckpointManager", Recording)
    out = train.main(SMOKE + ["--steps", "12", "--ckpt", str(tmp_path), "--ckpt-every", "4",
                              "--fail-at", "6", "--svc-every", "2", "--mixture-every", "4"])
    assert sorted(out) == ["first_loss", "last_loss", "steps", "wall_s"]
    assert restored == [4]
    assert out["steps"] == 12 + (6 - 4)  # steps 5 and 6 run again after the restore
    assert np.isfinite(out["last_loss"])
    log = capsys.readouterr().out
    assert "[elastic] lost hosts [3]" in log and "restored step 4" in log
    assert CheckpointManager(str(tmp_path)).list_steps() == [4, 8, 12]

    # a new run on the same directory resumes from its last checkpoint
    again = train.main(SMOKE + ["--steps", "14", "--ckpt", str(tmp_path), "--ckpt-every", "4"])
    assert restored[-1] == 12 and again["steps"] == 2


def test_losses_match_jax_launcher(monkeypatch):
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import train as jax_train
    from repro.models import get_model as jax_get_model
    from repro_torch.models.convert import from_jax_params
    from repro_torch.training import adamw_init
    from repro_torch.training.train_step import TrainState, trainable

    arch = "phi3-mini-3.8b"

    def jax_masters(model, seed):
        jp = jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(seed))
        params = from_jax_params(jax.tree.map(np.asarray, jp), model.cfg, device="cpu",
                                 masters=True)
        return TrainState(params, adamw_init(trainable(params)),
                          torch.zeros((), dtype=torch.int32))

    monkeypatch.setattr(train, "init_train_state", jax_masters)
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "100", "--svc-every", "1"]
    want = jax_train.main(argv)
    got = train.main(argv + ["--device", "cpu"])
    assert got["steps"] == want["steps"] == 3
    for key in ("first_loss", "last_loss"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key


def test_build_matches_jax_schedule_and_refuses_without_a_card(monkeypatch):
    args = train.parser().parse_args(SMOKE + ["--steps", "6"])
    cfg, model, pipe, stats, step_fn = train.build(args)
    assert model.train and model.device.type == "cpu" and pipe.device.type == "cpu"
    assert stats.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        train.build(train.parser().parse_args(["--arch", "gemma-2b", "--smoke"]))


def test_launcher_trains_the_ssm_arch(capsys):
    out = train.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu", "--steps", "4",
                      "--batch", "4", "--seq", "16", "--log-every", "1", "--svc-every", "2",
                      "--mixture-every", "3"])
    assert out["steps"] == 4 and np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert capsys.readouterr().out.count("step ") >= 4


def test_launcher_refuses_the_encdec_arch_before_the_first_step(monkeypatch):
    stepped = []
    monkeypatch.setattr(train, "make_train_step", lambda *a, **k: stepped.append(1))
    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                    "--steps", "2"])
    assert not stepped
