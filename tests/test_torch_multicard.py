"""Several cards in one process, on the CPU: the port's §7.5 paths over a
4-shard mesh against JAX's over four devices, and the device handling of
the kernel wrappers.

* JAX runs in a child process with ``XLA_FLAGS=--xla_force_host_platform_
  device_count=4`` (as ``benchmarks/fig9_distributed.py`` runs it; never in
  this process): ``fleet_scores_sharded``, both sharded delta group-bys and
  one ``ShardedFleet`` plan preview over a 4-device mesh.  The port runs
  the same over ``make_local_mesh(data=4, device="cpu")``.  Scores are
  bit-equal, counts and plan exact, sums within ``rtol=1e-6, atol=1e-4``
  (``tests/test_fleet_panel.py:257``: the two group-bys add in another
  order).  The child caps XLA's CPU target at AVX
  (``--xla_cpu_max_isa=AVX``): on a CPU with FMA3, XLA contracts the
  score's a·b + c into one fused multiply-add, a rounding the reference
  does not make; without FMA every op rounds once, as the reference, the
  port and the CUDA kernel do.
* ``kernels._build``: ``stream``, ``check_cuda`` and ``launch_on`` (which
  appends the card's current stream) take the card that holds the tensors (``torch._C``'s device hooks monkeypatched:
  this build of torch has no CUDA), a card index past ``device_count()``
  raises, and the per-card workspace and counter caches key ``cuda``
  (no index) as the current card.
* A source check: no launcher in ``csrc/*.cu`` keeps the result of
  ``cudaFuncSetAttribute``, ``cudaDeviceGetAttribute`` or an occupancy
  query in a function-scope ``static`` that is not per card.
* ``FleetScores.score`` and ``CostModel.observe_ingest`` against JAX's.

Tests set torch to one thread.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.planner as jplanner
import repro.views as jviews
import repro_torch.planner as tplanner
import repro_torch.views as tviews
from repro.core import ViewDef as JViewDef
from repro.relational.plan import GroupByNode as JGroupByNode
from repro.relational.plan import Scan as JScan
from repro.relational.relation import from_columns as jax_from_columns
from repro_torch.core import ViewDef
from repro_torch.core import distributed_svc as tsvc
from repro_torch.distributed import ShardedFleet
from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_score import N_FEATURES, N_SCORES, fleet_scores_sharded
from repro_torch.launch.mesh import LocalMesh, device_arg, make_local_mesh, on_device
from repro_torch.relational.plan import GroupByNode, Scan
from repro_torch.relational.relation import from_columns
from repro_torch.streaming import PartitionedDeltaLog
from torch_multicard_inputs import G, M, N_VIEWS, PER, SEED, SHARDS, inputs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# the JAX side, in a child with four host devices; it prints one JSON line
_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_max_isa=AVX")
import json, sys
import numpy as np, jax
sys.path.insert(0, sys.argv[1])
from torch_multicard_inputs import G, M, N_VIEWS, PER, SEED, SHARDS, inputs
from repro.core import ViewDef
from repro.core.distributed_svc import (make_sharded_delta_groupby,
                                        make_sharded_fused_delta_groupby, stack_shard_deltas)
from repro.distributed import ShardedFleet
from repro.kernels.fleet_score import fleet_scores_sharded
from repro.launch.mesh import make_local_mesh
from repro.relational.plan import GroupByNode, Scan
from repro.relational.relation import from_columns
from repro.streaming import PartitionedDeltaLog

assert len(jax.devices()) == 4
stacked, delta, bases, deltas = inputs()
mesh = make_local_mesh(data=SHARDS)
out = {"scores": np.asarray(fleet_scores_sharded(stacked, mesh=mesh,
                                                 shard_views=[16, 16, 10, 16])).tolist()}
plog = PartitionedDeltaLog("Log", n_shards=SHARDS)
for s in range(SHARDS):
    rows = slice(s * PER, (s + 1) * PER)
    plog.offer(s, inserts=from_columns({c: v[rows] for c, v in delta.items()},
                                       pk=["sessionId"]), seq=0)
keys, valid, values = stack_shard_deltas(plog.drain(), "videoId", ["bytes"], rows_per_shard=PER)
for name, make in (("fused", make_sharded_fused_delta_groupby),
                   ("unfused", make_sharded_delta_groupby)):
    got = make(mesh, "data", G, M, SEED, ["bytes"])(keys, valid, values)
    out[name] = {k: np.asarray(v).tolist() for k, v in got.items()}
fleet = ShardedFleet(n_shards=SHARDS, budget_s=0.5, clock=lambda: 0.0, mesh=mesh,
                     heartbeat_timeout_s=1e9)
for i in range(N_VIEWS):
    fleet.register_base(f"Log{i}", from_columns(bases[i], pk=["k"], capacity=2048))
    plan = GroupByNode(child=Scan(f"Log{i}", pk=("k",)), keys=("g",),
                       aggs=(("total", "sum", "v"), ("cnt", "count", None)), num_groups=16)
    fleet.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.4, seed=i,
                        delta_group_capacity=16)
for i, cm in enumerate(fleet.cost_models):
    cm.pin_costs(0.05 * (1 + i), 0.25)
for i in range(N_VIEWS):
    fleet.vm_of(f"v{i}").ingest(f"Log{i}", inserts=from_columns(deltas[i], pk=["k"]))
rep = fleet.epoch_step(execute=False)
out["plan"] = {"actions": sorted([a.view, a.action, a.shard, a.forced, a.predicted_s,
                                  float(a.score)] for a in rep.actions),
               "skipped": sorted(rep.skipped)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_four_devices():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT / "tests")], capture_output=True,
                       text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _port_groupbys(delta):
    plog = PartitionedDeltaLog("Log", n_shards=SHARDS)
    for s in range(SHARDS):
        rows = slice(s * PER, (s + 1) * PER)
        plog.offer(s, inserts=from_columns({c: v[rows] for c, v in delta.items()},
                                           pk=["sessionId"], device="cpu"), seq=0)
    keys, valid, values = tsvc.stack_shard_deltas(plog.drain(), "videoId", ["bytes"],
                                                  rows_per_shard=PER)
    mesh = make_local_mesh(data=SHARDS, device="cpu")
    return {name: make(mesh, "data", G, M, SEED, ["bytes"])(keys, valid, values)
            for name, make in (("fused", tsvc.make_sharded_fused_delta_groupby),
                               ("unfused", tsvc.make_sharded_delta_groupby))}


def _port_plan(bases, deltas):
    mesh = make_local_mesh(data=SHARDS, device="cpu")
    fleet = ShardedFleet(n_shards=SHARDS, budget_s=0.5, clock=lambda: 0.0, mesh=mesh,
                         heartbeat_timeout_s=1e9, device="cpu")
    for i in range(N_VIEWS):
        fleet.register_base(f"Log{i}", from_columns(bases[i], pk=["k"], capacity=2048,
                                                    device="cpu"))
        plan = GroupByNode(child=Scan(f"Log{i}", pk=("k",)), keys=("g",),
                           aggs=(("total", "sum", "v"), ("cnt", "count", None)), num_groups=16)
        fleet.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.4, seed=i,
                            delta_group_capacity=16)
    for i, cm in enumerate(fleet.cost_models):
        cm.pin_costs(0.05 * (1 + i), 0.25)
    for i in range(N_VIEWS):
        fleet.vm_of(f"v{i}").ingest(f"Log{i}", inserts=from_columns(deltas[i], pk=["k"],
                                                                     device="cpu"))
    rep = fleet.epoch_step(execute=False)
    return fleet, rep


def test_port_over_a_4_shard_mesh_matches_jax_over_4_devices(jax_four_devices):
    want = jax_four_devices
    stacked, delta, bases, deltas = inputs()
    mesh = make_local_mesh(data=SHARDS, device="cpu")
    got = fleet_scores_sharded(torch.from_numpy(stacked), mesh=mesh,
                               shard_views=[16, 16, 10, 16]).numpy()
    jscores = np.asarray(want["scores"], np.float32)
    assert got.shape == jscores.shape == (SHARDS, 16, N_SCORES)
    assert np.array_equal(got.view(np.int32), jscores.view(np.int32))

    port = _port_groupbys(delta)
    for name in ("fused", "unfused"):
        for other in ("fused", "unfused"):  # each port group-by against both of JAX's
            j = {k: np.asarray(v, np.float32) for k, v in want[other].items()}
            assert sorted(port[name]) == sorted(j) == ["bytes", "count"]
            np.testing.assert_array_equal(port[name]["count"].numpy(), j["count"])
            np.testing.assert_allclose(port[name]["bytes"].numpy(), j["bytes"], rtol=1e-6,
                                       atol=1e-4)
    assert 0 < float(port["fused"]["count"].sum()) < SHARDS * PER

    fleet, rep = _port_plan(bases, deltas)
    assert fleet.devices == [torch.device("cpu")] * SHARDS
    plan = sorted([a.view, a.action, a.shard, a.forced, a.predicted_s, float(a.score)]
                  for a in rep.actions)
    assert plan == [list(a) for a in want["plan"]["actions"]] and plan
    assert sorted(rep.skipped) == want["plan"]["skipped"]
    assert len({a[2] for a in plan}) > 1  # several shards act


def test_fleet_ingest_queues_each_partition_on_its_shards_device():
    _stacked, _delta, bases, deltas = inputs()
    fleet, _rep = _port_plan(bases, deltas)
    seen = []
    for plog in fleet.plogs.values():
        real = plog.offer

        def offer(shard, inserts=None, deletes=None, seq=None, key=None, real=real):
            seen.append((shard, inserts.valid.device))
            return real(shard, inserts=inserts, deletes=deletes, seq=seq, key=key)

        plog.offer = offer
    for i in range(N_VIEWS):
        fleet.ingest(f"Log{i}", inserts=from_columns(deltas[i], pk=["k"], device="cpu"), seq=1)
    assert sorted(s for s, _d in seen) == sorted(fleet.shard_of(f"v{i}") for i in range(N_VIEWS))
    assert all(d == fleet.devices[s] for s, d in seen)
    assert fleet.pending_rows() == N_VIEWS * 40


# ---------------------------------------------------------------------------
# kernels._build: the card that holds the tensors
# ---------------------------------------------------------------------------

class FakeCards:
    """torch._C's CUDA device hooks for ``n`` cards, card ``current`` current."""

    def __init__(self, monkeypatch, n=4, current=0):
        self.n, self.current, self.sets = n, current, []
        for name, fn in (("_cuda_getDevice", lambda: self.current),
                         ("_cuda_setDevice", self._set),
                         ("_cuda_maybeExchangeDevice", self._set),
                         ("_cuda_getCurrentRawStream", lambda i: 1000 + i)):
            monkeypatch.setattr(torch._C, name, fn, raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: self.n)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(B, "_visible", 0)  # read the fake count afresh
        monkeypatch.setattr(B, "_runtime_checked", set(range(n)))

    def _set(self, i):
        self.sets.append(i)
        prev, self.current = self.current, i
        return prev


@pytest.fixture
def cards(monkeypatch):
    return FakeCards(monkeypatch)


def test_stream_reads_the_tensors_card(cards):
    assert B.stream(torch.device("cuda", 2)) == 1002
    assert B.stream(3) == 1003
    assert B.stream(torch.device("cuda")) == B.stream() == 1000  # the current card
    cards.current = 1
    assert B.stream(torch.device("cuda")) == 1001 and B.stream(torch.device("cuda", 2)) == 1002


def test_check_cuda_takes_any_visible_card_and_refuses_the_rest(cards):
    assert [B.check_cuda(torch.device("cuda", i)) for i in range(4)] == [0, 1, 2, 3]
    assert B.check_cuda("cuda:3") == 3
    cards.current = 2
    assert B.check_cuda(torch.device("cuda")) == 2
    for bad in ("cuda:4", torch.device("cuda", 9)):
        with pytest.raises(ValueError, match="not a visible CUDA device: this process sees 4"):
            B.check_cuda(bad)
    with pytest.raises(ValueError, match="no kernel for tensors on cpu"):
        B.check_cuda(torch.device("cpu"))


def test_launch_on_makes_the_card_current_only_while_it_launches(cards, monkeypatch):
    during = []

    def entry(*args):
        during.append((cards.current, args))
        return 0 if args[0] != "fail" else 700

    monkeypatch.setattr(B, "function", lambda name, argtypes: entry)
    B.launch_on(0, "svc_x", (), "a")
    assert during[-1] == (0, ("a", 1000)) and cards.sets == []  # already current: no switch
    B.launch_on(2, "svc_x", (), "b")  # card 2's stream appended, card 2 current meanwhile
    assert during[-1] == (2, ("b", 1002)) and cards.sets == [2, 0] and cards.current == 0
    monkeypatch.setattr(B, "library", lambda: type("L", (), {
        "svc_error_string": staticmethod(lambda rc: b"injected")})())
    with pytest.raises(RuntimeError, match="svc_x: CUDA error 700"):
        B.launch_on(3, "svc_x", (), "fail")
    assert cards.current == 0 and cards.sets == [2, 0, 3, 0]  # switched back after the error


def test_the_first_launch_on_a_card_checks_the_librarys_runtime(cards, monkeypatch):
    lib = type("L", (), {})()
    lib.svc_current_device = lambda: cards.current
    monkeypatch.setattr(B, "library", lambda: lib)
    monkeypatch.setattr(B, "function", lambda name, argtypes: lambda *a: 0)
    monkeypatch.setattr(B, "_runtime_checked", set())
    B.launch_on(1, "svc_x", ())
    assert B._runtime_checked == {1}
    lib.svc_current_device = lambda: 0  # a runtime that did not follow PyTorch's switch
    with pytest.raises(RuntimeError, match="runtime is on device 0"):
        B.launch_on(3, "svc_x", ())
    assert cards.current == 0


def test_per_card_caches_key_cuda_as_the_current_card(cards, monkeypatch):
    from repro_torch.kernels.corr_diff import ops as corr_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_clean import ops as fused_ops
    from repro_torch.kernels.multi_agg import ops as agg_ops
    from repro_torch.kernels.segment_aggsum import ops as seg_ops

    made = []
    real_zeros = torch.zeros

    def zeros(*shape, device=None, **kw):  # CPU storage, the card it was asked for noted
        made.append(torch.device(device))
        return real_zeros(*shape, **kw)

    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(B, "sm_count", lambda i: 132)
    for mod, name in ((fused_ops, "_overflow"), (agg_ops, "_workspace"),
                      (flash_ops, "_workspace"), (seg_ops, "_workspace"),
                      (corr_ops, "_workspace")):
        monkeypatch.setattr(mod, name, {})
    caches = (lambda d: fused_ops.overflow_counter(d),
              lambda d: agg_ops.workspace(d, 64, "partials"),
              lambda d: flash_ops.workspace(d, 64),
              lambda d: seg_ops._records(d)[0],
              lambda d: corr_ops._partials(d, 1000 + B.index(d))[0])
    for get in caches:
        for current in (0, 2):
            cards.current = current
            a = get(torch.device("cuda"))
            assert get(torch.device("cuda", current)) is a
            assert get("cuda") is a
            assert get(torch.device("cuda", 3 - current)) is not a
    assert made and all(d.type == "cuda" and d.index is not None for d in made)


def test_every_wrapper_launches_on_its_tensors_card():
    """Source check: each ``ops.py`` launches through ``B.launch_on`` on
    ``card``, the index of its tensors' device taken just before (the
    stream is that card's, appended by ``launch_on``), never through a bare
    ``B.launch`` or the current card's stream."""
    ops = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/ops.py"))
    assert len(ops) == 13
    launches = 0
    for path in ops:
        src = path.read_text()
        assert not re.search(r"\bB\.launch\(", src), path
        assert "B.stream()" not in src, path
        for call in re.finditer(r"B\.launch_on\(\s*([\w.]+)\s*,", src):
            head = src.rfind("\ndef ", 0, call.start())
            tail = src.find("\ndef ", call.end())
            body = src[head:tail if tail > 0 else len(src)]  # the enclosing function
            assert call.group(1) == "card", (path, call.group(1))
            assert re.search(r"\n\s+card = (dev|[\w.]+\.device)\.index\n", body), path
            launches += 1
    assert launches == 27


_SETTERS = re.compile(r"cuda(FuncSetAttribute|DeviceGetAttribute|"
                      r"OccupancyMaxActiveBlocksPerMultiprocessor)\s*\(")


def per_device_static_findings(source: str) -> list:
    """Function-scope ``static`` variables of a CUDA source (indented, not
    ``constexpr``, not a ``svc::PerDevice`` table) that take the result of
    ``cudaFuncSetAttribute``, ``cudaDeviceGetAttribute`` or an occupancy
    query: per-card facts kept once for the whole process."""
    lines = source.splitlines()
    found = []
    for i, line in enumerate(lines):
        m = re.match(r"^\s+static\s+(?!constexpr)(?!svc::PerDevice)(?:const\s+)?[\w:<>]+\s+(\w+)",
                     line)
        if not m:
            continue
        name = m.group(1)
        body = "\n".join(lines[i:i + 12])
        if _SETTERS.search(body) and re.search(rf"\b{name}\b", body[len(line):]):
            found.append(f"{i + 1}: {line.strip()}")
        elif re.search(rf"\b{name}\s*=\s*{_SETTERS.pattern}", body):
            found.append(f"{i + 1}: {line.strip()}")
    return found


def test_no_launcher_keeps_a_cards_attributes_for_every_card():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert len(sources) >= 12
    for path in sources:
        assert per_device_static_findings(path.read_text()) == [], path
    tables = sum(p.read_text().count("svc::PerDevice<") for p in sources)
    assert tables >= 11  # the sites that were process-wide statics, one table each
    # the check finds the forms the launchers used to have
    for bad in ("  static const cudaError_t attr = cudaFuncSetAttribute(\n"
                "      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 1024);\n",
                "  static int resident = 0;\n  if (resident == 0) {\n    int dev = 0;\n"
                "    cudaDeviceGetAttribute(&resident, cudaDevAttrMultiProcessorCount, dev);\n",
                "  static int allowed = 48 * 1024;\n  if (smem > allowed) {\n"
                "    const cudaError_t err = cudaFuncSetAttribute(k, a, smem);\n"
                "    allowed = smem;\n"):
        assert per_device_static_findings(bad), bad


# ---------------------------------------------------------------------------
# meshes and launcher devices
# ---------------------------------------------------------------------------

def test_local_mesh_of_four_cpu_shards_and_the_device_flag():
    mesh = make_local_mesh(data=4, device="cpu")
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 4
    m = LocalMesh(["cpu", "cuda:1", "cuda:0", "cuda:3"], {"data": 4})
    assert [str(d) for d in m.axis_devices("data")] == ["cpu", "cuda:1", "cuda:0", "cuda:3"]
    assert device_arg("cuda:2") == torch.device("cuda", 2)
    assert device_arg("cuda") == torch.device("cuda") and device_arg("cpu").type == "cpu"
    import argparse

    for bad in ("tpu", "cpu:1", "cuda:x"):
        with pytest.raises(argparse.ArgumentTypeError):
            device_arg(bad)
    with on_device("cpu"):
        pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not a visible CUDA device"):
            on_device("cuda:1")


def test_local_mesh_names_cuda_by_the_current_card(cards):
    cards.current = 1
    m = LocalMesh(["cuda"] * 2, {"data": 2})
    assert m.devices == [torch.device("cuda", 1)] * 2


# ---------------------------------------------------------------------------
# the planner functions the fleet uses
# ---------------------------------------------------------------------------

def test_fleet_scores_score_matches_jax():
    rng = np.random.default_rng(3)
    names = ["a", "b", "c"]
    feats = rng.uniform(size=(3, N_FEATURES)).astype(np.float32)
    scores = rng.uniform(size=(3, N_SCORES)).astype(np.float32)
    j = jplanner.score.FleetScores(names=names, features=feats, scores=scores)
    t = tplanner.score.FleetScores(names=names, features=feats, scores=scores)
    for n in names:
        for action in ("skip", "clean", "maintain", "retune"):
            assert t.score(n, action) == j.score(n, action)
            assert isinstance(t.score(n, action), float)
    for bad in (("a", "rebuild"), ("z", "clean")):
        with pytest.raises((KeyError, ValueError)):
            j.score(*bad)
        with pytest.raises((KeyError, ValueError)):
            t.score(*bad)


def _observed_ingests(views, core_viewdef, groupby, scan, make_rel, costs, **dev):
    calls = []

    class Recording(costs.CostModel):
        def observe_ingest(self, base, n_rows):
            super().observe_ingest(base, n_rows)
            calls.append((base, int(n_rows)))

    vm = views.ViewManager(**dev)
    vm.register_base("Log", make_rel({"k": np.arange(100, dtype=np.int32),
                                      "g": (np.arange(100) % 7).astype(np.int32),
                                      "v": np.ones(100, np.float32)}, capacity=256))
    plan = groupby(child=scan("Log", pk=("k",)), keys=("g",),
                   aggs=(("total", "sum", "v"),), num_groups=16)
    vm.register_view(core_viewdef("v", plan), delta_bases=("Log",), m=0.5, seed=1)
    assert Recording(vm).attach().observe_ingest("Log", 0) is None
    calls.clear()
    vm.ingest("Log", inserts=make_rel({"k": np.arange(100, 130, dtype=np.int32),
                                       "g": np.zeros(30, np.int32),
                                       "v": np.ones(30, np.float32)}))
    vm.ingest("Log", deletes=make_rel({"k": np.arange(5, dtype=np.int32),
                                       "g": np.zeros(5, np.int32),
                                       "v": np.ones(5, np.float32)}))
    vm.ingest("Log", inserts=make_rel({"k": np.arange(0, dtype=np.int32),
                                       "g": np.zeros(0, np.int32),
                                       "v": np.ones(0, np.float32)}))
    return calls


def test_ingest_calls_observe_ingest_as_jax():
    import repro.planner.costs as jcosts
    import repro_torch.planner.costs as tcosts

    want = _observed_ingests(jviews, JViewDef, JGroupByNode, JScan,
                             lambda c, **kw: jax_from_columns(c, pk=["k"], **kw), jcosts)
    got = _observed_ingests(tviews, ViewDef, GroupByNode, Scan,
                            lambda c, **kw: from_columns(c, pk=["k"], device="cpu", **kw),
                            tcosts, device="cpu")
    assert got == want == [("Log", 30), ("Log", 5)]
