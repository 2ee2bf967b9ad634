"""The port's spans, counters and phase marks (`ssv_tpu_torch/utils/trace.py`),
on the CPU: an eager step under a profiler shows `step <s>` over its phase
ranges in order; no profiler, no `record_function`; the recorded-span ring
is bounded and knows each span's parent; the counters count what the
scattered attributes they replace counted (the graph's warm-up, capture,
replays and drops, the photometric launches with the replays', the
collectives); the marks change no number on the CPU; the epoch's median
phases from its stamps. The mark kernel itself runs on the card
(`perfbench/tests/test_perfbench_phases.py`, marked `card`)."""

import contextlib
import json
import os
from collections import deque

import pytest
import torch
import torch.distributed as dist
import yaml

import helpers
from ssv_tpu_torch import bench
from ssv_tpu_torch.parallel import per_device
from ssv_tpu_torch.tools import sweep
from ssv_tpu_torch.train import graph as graph_mod
from ssv_tpu_torch.train.trainer import BOUNDARY, Trainer
from ssv_tpu_torch.utils import trace

torch.set_num_threads(2)

PHASES = {"simclr": ["views", "forward", "loss", "backward", "optimizer", "state"],
          "byol": ["views", "forward", "loss", "backward", "optimizer", "state"],
          "simsiam": ["views", "forward", "backward", "optimizer", "state"]}


def _trainer(tmp_path, algo="simclr", epochs=1, make_dirs=False, load=None, output="run",
             **cfg_extra):
    """`mini_config(algo)` on `tiny`, 64 / 32 synthetic images: 4 steps an
    epoch at batch 16."""
    cfg = helpers.mini_config(algo, epochs=epochs)
    cfg.update(cfg_extra)
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return Trainer({"config": str(path), "algo": algo, "arch": "tiny", "task": "train",
                    "output": output, "load": load}, synthetic_sizes=(64, 32), device="cpu",
                   make_dirs=make_dirs)


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in trace.counters.items() if v != before.get(k, 0)}


@pytest.fixture
def record_functions(monkeypatch):
    """Counts every `torch.profiler.record_function` the port enters."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


# --------------------------------------------------------------------------
# host ranges
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["simclr", "byol", "simsiam"])
def test_profiled_eager_step_shows_its_phases_in_order(algo, tmp_path, monkeypatch):
    """Under a CPU profiler, each eager step through `Trainer.step` is a
    range `step <s>` holding the ranges `phase.<mark>` in the step's order,
    one after another inside it; SimSiam marks no loss, so its loss stays in
    `forward`."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path, algo)
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state)
        trainer.step(state)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith(("step ", "phase."))]
    for s in range(2):
        (_, a, b), = [e for e in events if e[0] == f"step {s}"]
        inside = sorted((e for e in events if e[0].startswith("phase.") and a <= e[1] <= b),
                        key=lambda e: e[1])
        assert [n[len("phase."):] for n, _, _ in inside] == PHASES[algo]
        assert all(x[2] <= b for x in inside)
        assert all(x[2] <= y[1] for x, y in zip(inside, inside[1:]))


def test_no_profiler_enters_no_record_function(tmp_path, monkeypatch, record_functions):
    """Without a profiler, a whole `train()` (set-up, steps, boundary, KNN,
    checkpoint, probe) enters no `record_function` of the port; with one,
    the steps and phases do."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path, eval_every=1, linear_eval={"epochs": 1})
    trainer.make_dirs = True
    os.makedirs(trainer.output_dir, exist_ok=True)
    trainer.train()
    assert record_functions == []
    trainer.begin_epoch(trainer.epoch_indices())
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.step(trainer.state)
    assert record_functions[:2] == ["step 0", "phase.views"]


# --------------------------------------------------------------------------
# the recorded-span ring
# --------------------------------------------------------------------------

def test_ring_is_bounded_and_knows_parents(tmp_path, monkeypatch):
    """Recorded spans go into a ring of the last `maxlen`; each carries its
    enclosing recorded span's name as parent (unrecorded spans are not
    parents); `since` returns what was recorded after a token as far as the
    ring holds it; `write` appends them as JSON lines and empties the ring."""
    monkeypatch.setattr(trace, "spans", deque(maxlen=8))
    with trace.span("outer", record=True):
        with trace.span("plain"):
            with trace.span("inner", record=True):
                pass
    assert [(n, p) for n, p, _, _ in trace.spans] == [("inner", "outer"), ("outer", None)]
    t0, t1 = trace.spans[1][2:]
    assert t0 <= trace.spans[0][2] <= trace.spans[0][3] <= t1
    assert trace.last_seconds("outer") == pytest.approx((t1 - t0) / 1e9)
    token = trace.position()
    for i in range(20):
        with trace.span(f"s{i}", record=True):
            pass
    assert len(trace.spans) == 8
    assert [s[0] for s in trace.since(token)] == [f"s{i}" for i in range(12, 20)]
    assert [s[0] for s in trace.since(trace.position() - 3)] == ["s17", "s18", "s19"]
    assert trace.since(trace.position()) == []
    assert trace.seconds(["s19", "none"], trace.since(token))["none"] == 0.0
    trace.write(str(tmp_path / "spans.jsonl"))
    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [x["name"] for x in lines] == [f"s{i}" for i in range(12, 20)]
    assert set(lines[0]) == {"name", "parent", "start_ns", "end_ns"}
    assert len(trace.spans) == 0


def test_setup_and_boundary_spans_in_the_epoch_record(tmp_path, monkeypatch):
    """`Trainer.__init__` records `setup.config`, `.pipeline`, `.algorithm`
    and `.state` (and `setup.load` with `load`); `train()` writes each
    epoch's boundary seconds (`boundary_s`), the counters and `phase_ms`
    (None off CUDA) into its record, and the spans to `spans.jsonl`."""
    monkeypatch.chdir(tmp_path)
    token = trace.position()
    trainer = _trainer(tmp_path, epochs=2, eval_every=2, linear_eval={"epochs": 1},
                       make_dirs=True)
    setup = [s for s in trace.since(token) if s[0].startswith("setup.")]
    assert [s[0] for s in setup] == ["setup.config", "setup.pipeline", "setup.algorithm",
                                     "setup.state"]
    trainer.train()
    first, second = trainer.epoch_stats
    for stats in trainer.epoch_stats:
        assert stats["phase_ms"] is None and set(stats["boundary_s"]) == set(BOUNDARY)
        assert all(v >= 0 for v in stats["boundary_s"].values())
        assert stats["counters"] == json.loads(json.dumps(stats["counters"]))
    assert first["boundary_s"]["begin_epoch"] > 0 and first["boundary_s"]["knn_eval"] == 0
    assert second["boundary_s"]["knn_eval"] > 0 and second["boundary_s"]["checkpoint"] > 0
    lines = (tmp_path / trainer.output_dir / "spans.jsonl").read_text().splitlines()
    names = [json.loads(x)["name"] for x in lines]
    assert {"setup.state", "epoch_indices", "checkpoint", "knn_eval"} <= set(names)
    assert not any(n.startswith(("step", "phase")) for n in names)
    token = trace.position()
    _trainer(tmp_path, epochs=2, load=trainer.output_dir, output="resumed")
    assert [s[0] for s in trace.since(token) if s[0].startswith("setup.")] == [
        "setup.config", "setup.pipeline", "setup.algorithm", "setup.state", "setup.load"]


def test_epoch_record_counts_its_steps_launches(tmp_path, monkeypatch):
    """An epoch record's `photometric_launches` and `stem_launches` are its
    steps' launches (two and six a step here, as the wrappers count them on
    the card), not the KNN eval's after the epoch (two stem launches a
    batch in eval mode on the card) or the probe's."""
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path, epochs=2, eval_every=1, linear_eval={"epochs": 1},
                       make_dirs=True)
    step, knn = trainer._train_step, trainer.knn_validate

    def counted_step(state):
        trace.count("photometric.launches", 2)
        trace.count("stem.launches", 6)
        step(state)

    def counted_knn():
        trace.count("stem.launches", 2)
        return knn()

    trainer._train_step, trainer.knn_validate = counted_step, counted_knn
    before = dict(trace.counters)
    trainer.train()
    steps = [stats["steps"] for stats in trainer.epoch_stats]
    assert steps == [4, 4]
    assert [s["photometric_launches"] for s in trainer.epoch_stats] == [8, 8]
    assert [s["stem_launches"] for s in trainer.epoch_stats] == [24, 24]
    got = _delta(before)
    assert (got["photometric.launches"], got["stem.launches"]) == (16, 48 + 2 * 2)


# --------------------------------------------------------------------------
# the counters
# --------------------------------------------------------------------------

class _FakeGraph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda_graph(monkeypatch):
    """`train/graph.py`'s CUDA calls made to run on the CPU: the capture runs
    the step once, a replay runs nothing; every step of the trainer's counts
    two photometric launches and six stem launches, as the wrappers count
    them on the card."""
    stream = _FakeStream()
    monkeypatch.setattr(graph_mod, "side_stream", lambda device: stream)
    for name, fn in (("current_stream", lambda device=None: stream),
                     ("stream", lambda s: contextlib.nullcontext()),
                     ("synchronize", lambda device=None: None),
                     ("empty_cache", lambda: None),
                     ("memory_reserved", lambda device=None: 0),
                     ("CUDAGraph", _FakeGraph),
                     ("graph", lambda g, **kw: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fn)

    def make(tmp_path, **kwargs):
        trainer = _trainer(tmp_path, **{"epochs": 50, **kwargs})
        trainer.epoch_mode = "graph"
        real = trainer._train_step

        def step(state):
            trace.count("photometric.launches", 2)
            trace.count("stem.launches", 6)
            real(state)

        trainer._train_step = step
        return trainer

    return make


def test_graph_counters_count_as_the_old_attributes(tmp_path, monkeypatch, fake_cuda_graph,
                                                    record_functions):
    """Three warm-up steps, one capture and replays: `graph.warmup_steps` 3,
    `graph.captures` 1, `graph.replays` and `StepGraph.replays` the replays,
    `photometric.launches` two a step and `stem.launches` six, replays
    included (the old wrapper's count plus `StepGraph.replayed_launches`),
    and the graph's own count of the launches it holds; recorded spans only for the warm-up steps and the
    capture, none a replay, and no `record_function` without a profiler."""
    monkeypatch.chdir(tmp_path)
    trainer = fake_cuda_graph(tmp_path)
    state = trainer.state
    trainer.begin_epoch(trainer.epoch_indices())
    before, token = dict(trace.counters), trace.position()
    for _ in range(4):
        trainer.step(state)
    assert [s[0] for s in trace.since(token)] == ["graph.warmup"] * 3 + ["graph.capture"]
    for _ in range(2):
        trainer.step(state)
    assert [s[0] for s in trace.since(token)] == ["graph.warmup"] * 3 + ["graph.capture"]
    assert _delta(before) == {"graph.warmup_steps": 3, "graph.captures": 1,
                              "graph.replays": 3, "photometric.launches": 12,
                              "stem.launches": 36}
    assert trainer.graph.replays == 3
    assert trainer.graph.held == {"photometric.launches": 2, "stem.launches": 6,
                                  "attention.launches": 0, "vit.tokens": 0,
                                  "multicrop.crops": 0}
    assert trainer.photometric_launches() == trace.counters["photometric.launches"]
    assert state.step == 6 and trainer._host_pos == 6
    assert trace.last_seconds("graph.capture") >= 0
    assert record_functions == []


def test_epoch_record_carries_every_replayed_counter(tmp_path, monkeypatch, fake_cuda_graph):
    """A counter added to `trace.REPLAYED` needs no other edit: the graph
    holds it, its replays add it, and each epoch record carries it under its
    name with `_` for `.` (one a step: four an epoch, in the warm-up, the
    capture and the replays alike)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trace, "REPLAYED", trace.REPLAYED + ("sixth.count",))
    trainer = fake_cuda_graph(tmp_path, epochs=2, linear_eval={"epochs": 1}, make_dirs=True)
    step = trainer._train_step

    def counted(state):
        trace.count("sixth.count")
        step(state)

    trainer._train_step = counted
    trainer.train()
    assert trainer.graph.held["sixth.count"] == 1 and trainer.graph.replays == 5
    assert [s["sixth_count"] for s in trainer.epoch_stats] == [4, 4]
    assert [s["photometric_launches"] for s in trainer.epoch_stats] == [8, 8]


def test_graph_drops_are_counted_by_reason(tmp_path, monkeypatch, fake_cuda_graph):
    """Where the trainer drops a captured step: a checkpoint load (`load`),
    an epoch of another shape (`shape`), a schedule refill (`refill`); no
    drop is counted where there was no graph."""
    monkeypatch.chdir(tmp_path)
    trainer = fake_cuda_graph(tmp_path)
    trainer.make_dirs = True
    os.makedirs(trainer.output_dir, exist_ok=True)

    def steps(n):
        trainer.begin_epoch(trainer.epoch_indices())
        for _ in range(n):
            trainer.step(trainer.state)
        assert trainer.graph is not None and trainer.graph.replays == n - 3

    before = dict(trace.counters)
    trainer.begin_epoch(trainer.epoch_indices())
    trainer.save_checkpoint("latest", epoch=1)
    trainer.load_checkpoint(trainer.output_dir, "latest")
    assert _delta(before) == {}
    steps(4)
    trainer.load_checkpoint(trainer.output_dir, "latest")
    assert trainer.graph is None and _delta(before)["graph.drops.load"] == 1
    steps(4)
    trainer.begin_epoch(trainer.epoch_indices()[:2])
    assert trainer.graph is None and _delta(before)["graph.drops.shape"] == 1
    steps(4)
    sched = trainer.state.scheduler
    monkeypatch.setattr(sched, "reserve", lambda step: True)
    trainer.begin_epoch(trainer.epoch_indices())
    trainer.step(trainer.state)
    assert trainer.graph.warm == 1 and trainer.graph.replays == 0
    got = _delta(before)
    assert (got["graph.drops.load"], got["graph.drops.shape"], got["graph.drops.refill"]) == \
        (1, 1, 1)
    assert got["graph.captures"] == 3 and got["graph.replays"] == 3


def test_bench_line_counts_from_the_counters(tmp_path, monkeypatch):
    """The bench's CPU path (`ssv_tpu_torch.bench.measure`, step mode): its
    line's photometric launches and replays are the counters' (none on the
    CPU), and its capture seconds none, as the old attributes gave."""
    monkeypatch.chdir(tmp_path)
    trainer = bench.build_trainer(8, 32, "cpu")
    before = dict(trace.counters)
    line = bench.measure(trainer, 2)
    got = _delta(before)
    assert line["photometric_launches"] == got.get("photometric.launches", 0) == 0
    assert line["replays"] == got.get("graph.replays", 0) == 0
    assert line["capture_s"] is None and "graph.captures" not in got


def test_sweep_row_counts_from_the_counters(tmp_path, monkeypatch):
    """A sweep row on the CPU (`tools/sweep.py`): its photometric launches
    are the counter's difference over the row (none on the CPU)."""
    monkeypatch.chdir(tmp_path)
    before = dict(trace.counters)
    row = sweep.run_row("simclr", "simclr", "tiny", 16, {}, 1, sizes=(64, 32), device="cpu",
                        run_root=str(tmp_path / "sweep"))
    assert row["photometric_launches"] == _delta(before).get("photometric.launches", 0) == 0


def test_collectives_are_counted(tmp_path):
    """A reduce and a gather over a one-rank gloo group: `collectives.calls`
    2, `.bytes` the tensors' bytes, `.host_s` the host seconds inside."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        before = dict(trace.counters)
        per_device._all_reduce(torch.ones(5), None)
        per_device._all_gather(torch.ones(3, 2, dtype=torch.float64), None)
        got = _delta(before)
    finally:
        dist.destroy_process_group()
    assert got["collectives.calls"] == 2 and got["collectives.bytes"] == 5 * 4 + 6 * 8
    assert 0 < got["collectives.host_s"] < 60


# --------------------------------------------------------------------------
# the marks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["simclr", "byol"])
def test_marks_change_nothing_on_the_cpu(algo, tmp_path, monkeypatch):
    """On the CPU the marks write nothing (no stamps, `phase_ms` None), and
    two steps give bit for bit the losses and weights of two steps with
    `trace.phase` stubbed out."""
    monkeypatch.chdir(tmp_path)
    runs = []
    for stub in (False, True):
        with monkeypatch.context() as m:
            if stub:
                m.setattr(trace, "phase", lambda mark: None)
            trainer = _trainer(tmp_path, algo)
            state = trainer.algorithm.pre_train(trainer.state, trainer)
            trainer.begin_epoch(trainer.epoch_indices())
            trainer.step(state)
            trainer.step(state)
            runs.append((trainer._metric_bufs["loss"][:2].clone(),
                         [p.detach().clone() for p in state.model.parameters()]))
            assert trainer._stamps is None
    (loss_a, params_a), (loss_b, params_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_phase_outside_a_step_does_nothing(record_functions):
    """`phase` outside `Trainer._train_step` (an algorithm's step called on
    its own, as the parity tests call it) launches nothing and opens no
    range, with or without a profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        trace.phase("loss")
    trace.phase("loss")
    assert record_functions == []


def _stamps(rows):
    return torch.tensor(rows, dtype=torch.int64)


def test_phase_ms_from_stamps():
    """The medians of the phases over an epoch's stamps (ns -> ms), the gap
    between one step's `end` and the next step's `views`; a mark that no
    step wrote (0) merges its phase into the one before; no marks, None."""
    base = [0, 1_000_000, 2_000_000, 3_000_000, 5_000_000, 5_500_000, 5_600_000]
    rows = [[t + 10_000_000 * s + (s == 1) * 0 for t in base] for s in range(3)]
    rows[2][4] += 600_000          # step 2's backward 0.6 ms longer, the median keeps 2 ms
    got = trace.phase_ms(_stamps([[t + 1 for t in r] for r in rows]))
    assert got == pytest.approx({"views": 1.0, "forward": 1.0, "loss": 1.0, "backward": 2.0,
                                 "optimizer": 0.5, "state": 0.1, "between": 4.4})
    no_loss = [[t + 1 for t in r] for r in rows]
    for r in no_loss:
        r[2] = 0
    got = trace.phase_ms(_stamps(no_loss))
    assert "loss" not in got and got["forward"] == pytest.approx(2.0)
    assert trace.phase_ms(torch.zeros((3, 7), dtype=torch.int64)) is None
    assert trace.phase_ms(torch.zeros((0, 7), dtype=torch.int64)) is None
