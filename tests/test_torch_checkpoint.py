"""The port's checkpoint manager, and checkpoints across the two packages.

The manager keeps JAX's layout (``step_XXXXXXXX/{manifest.json,
host_0000.npz, COMMITTED}``, ``.tmp`` then a rename, retention, async
writes, partial checkpoints ignored) and JAX's leaf keys: a
``TrainState`` is flattened as JAX flattens its own, the port's per-layer
leaves stacked to JAX's (L, …) shapes.  So a train state saved by the
port restores into a JAX ``TrainState`` through JAX's
``CheckpointManager.restore``, and the reverse, bit for bit.
``models.convert.to_jax_params`` inverts ``from_jax_params`` exactly for
every family, the hybrid, ssm and encdec ones trained and checkpointed as
the transformer's are.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_get_model
from repro.training import AdamWConfig as JAdamW
from repro.training import init_train_state as jax_init_state
from repro.training import make_train_step as jax_make_step
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.training import AdamWConfig, init_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16), "d": torch.tensor(7)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, tree, extra={"step": 5})
    out = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.bfloat16),
                                         "d": torch.tensor(0)}}
    restored, extra = mgr.restore(out)
    assert restored is out and extra["step"] == 5
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert int(out["b"]["d"]) == 7
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert [leaf["key"] for leaf in manifest["leaves"]] == ["a", "b/c", "b/d"]
    assert manifest["leaves"][1]["dtype"] == "float32"  # bf16 widened
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(3, 2), "b": out["b"]})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"z": torch.zeros(1)})


def test_retention_and_latest(tmp_path):
    tree = {"a": torch.zeros(2)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.list_steps() == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "none")) is None


def test_partial_checkpoint_ignored(tmp_path):
    tree = {"a": torch.arange(2.0)}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    os.makedirs(tmp_path / "step_00000002")  # a crash mid-write: no COMMITTED
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert mgr.list_steps() == [1]
    out = {"a": torch.zeros(2)}
    mgr.restore(out)
    assert torch.equal(out["a"], tree["a"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(out)


def test_async_checkpoint_copies_before_returning(tmp_path):
    tree = {"a": torch.arange(1000, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    mgr.save(7, tree)
    tree["a"].zero_()  # the host copy was taken before save returned
    mgr.wait()
    assert mgr.list_steps() == [7]
    out = {"a": torch.zeros(1000)}
    mgr.restore(out)
    assert torch.equal(out["a"], torch.arange(1000, dtype=torch.float32))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


TRAIN_FAMILY_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ["gemma-2b", "grok-1-314b"] + TRAIN_FAMILY_ARCHS)
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    """A port train state after one step, saved by the port, restored by
    JAX's manager into JAX's TrainState: every leaf bit-equal (params, m,
    v, both steps), and JAX's step runs on it."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu", train=True)
    state = init_train_state(model, 0)
    state, _ = make_train_step(model, AdamWConfig(lr=1e-2))(
        state, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    CheckpointManager(str(tmp_path)).save(1, state, extra={"step": 1})
    jm = jax_get_model(jax_smoke(arch))
    template = jax_init_state(jm, jax.random.PRNGKey(1))
    restored, extra = JCheckpointManager(str(tmp_path)).restore(template)
    assert extra == {"step": 1}
    got = _flat(restored)
    assert int(got["2"]) == 1 and int(got["1/step"]) == 1
    if cfg.family in ("dense", "moe"):
        np.testing.assert_array_equal(got["0/layers/wq"][1], state.params.layers[1].wq.detach())
        np.testing.assert_array_equal(got["1/m/layers/w_up"][0],
                                      state.opt_state["m"]["layers.0.w_up"])
    np.testing.assert_array_equal(got["1/v/embed"], state.opt_state["v"]["embed"])
    from repro_torch.checkpoint.manager import host_leaves

    saved = dict(host_leaves(state))
    assert sorted(saved) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        keys = [leaf["key"] for leaf in json.load(f)["leaves"]]
    assert keys == list(_flat(template))  # JAX's flatten order
    new, metrics = jax.jit(jax_make_step(jm, JAdamW(lr=1e-2)))(
        restored, {k: jnp.asarray(v) for k, v in _batch(cfg, 1).items()})
    assert np.isfinite(float(metrics["loss"])) and int(new.step) == 2


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "grok-1-314b"] + TRAIN_FAMILY_ARCHS)
def test_jax_checkpoint_restores_in_the_port(arch, tmp_path):
    """JAX's train state after one step, saved by JAX's manager, restored
    by the port's into its TrainState: every leaf bit-equal, and the port's
    step continues from it."""
    jm = jax_get_model(jax_smoke(arch))
    jstate = jax_init_state(jm, jax.random.PRNGKey(0))
    jstate, _ = jax.jit(jax_make_step(jm, JAdamW(lr=1e-2)))(
        jstate, {k: jnp.asarray(v) for k, v in _batch(jax_smoke(arch)).items()})
    JCheckpointManager(str(tmp_path)).save(1, jstate, extra={"step": 1})
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu", train=True)
    state, extra = CheckpointManager(str(tmp_path)).restore(init_train_state(model, 5))
    assert extra == {"step": 1} and int(state.step) == 1 and state.step.dtype == torch.int32
    want = _flat(jstate)
    from repro_torch.checkpoint.manager import host_leaves

    got = dict(host_leaves(state))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state, metrics = make_train_step(model, AdamWConfig(lr=1e-2))(
        state, {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()})
    assert np.isfinite(float(metrics["loss"])) and int(state.opt_state["step"]) == 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_to_jax_params_inverts_from_jax_params(arch):
    """Every family: JAX's parameters carried into the port and back are
    JAX's exactly (keys, shapes, values), in the float32-master form the
    port trains and in the served form (the smoke configs' f32)."""
    jp = jax.tree.map(np.asarray, jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(3)))
    cfg = get_smoke_config(arch)
    for masters in (True, False):
        model = from_jax_params(jp, cfg, device="cpu", masters=masters)
        assert all(p.requires_grad == masters for p in model.parameters())
        back = to_jax_params(model)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
