"""DINO's phase marks and work counters (`ssv_tpu_torch/utils/trace.py`) and
the benchmark's readers of them, on the CPU: a DINO ViT step marks
`views, forward, student, loss, backward, optimizer, state, end` in that
order, each into its own column of the stamps, and SimCLR's and BYOL's
steps mark no `student`; after a capture and N replays the counters
`vit.tokens` and `multicrop.crops` hold N + 1 steps' counts; the six
readers of the `dino_vit_b64_multicrop` cell read a synthetic profile that
holds the marks, and nothing from one that does not."""

import contextlib

import pytest
import torch
import yaml

import helpers
from perfbench import harness
from ssv_tpu_torch.train import graph as graph_mod
from ssv_tpu_torch.train.trainer import Trainer
from ssv_tpu_torch.utils import trace

torch.set_num_threads(2)


def _trainer(tmp_path, algo="dino"):
    """`mini_config(algo)`, DINO on the test ViT (batch 8: 2 global 32x32
    crops of 64 patches and 2 local 8x8 crops of 4 a base view), the others
    on `tiny` (batch 16); 64 / 32 synthetic images."""
    cfg = helpers.mini_config(algo, epochs=50)
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    arch = "vit" if algo == "dino" else "tiny"
    return Trainer({"config": str(path), "algo": algo, "arch": arch, "task": "train",
                    "output": "run"}, synthetic_sizes=(64, 32), device="cpu", make_dirs=False)


# a step of mini_config's DINO at batch 8: the student over 2 x 2 global crops
# of 65 tokens and 2 x 2 local crops of 5, the teacher over the global crops
TOKENS_A_STEP = 8 * (4 * 65 + 4 * 5) + 8 * 4 * 65
CROPS_A_STEP = 8 * 2 * (2 + 2)


@pytest.fixture
def marks_made(monkeypatch):
    """The marks each `trace.phase` call made, in order."""
    made = []
    real = trace.phase

    def recording(mark):
        made.append(mark)
        return real(mark)

    monkeypatch.setattr(trace, "phase", recording)
    return made


@pytest.fixture
def stamping(monkeypatch):
    """The mark kernel's launch on the CPU: each call writes the next tick
    into `stamps[pos, column]` and records (kernel index, column)."""
    calls = []

    def fake(index, column, pos, stamps):
        calls.append((index, column))
        stamps[int(pos), column] = len(calls)

    monkeypatch.setattr(trace, "phase_mark", fake)
    return calls


def test_dino_step_marks_every_phase_in_order(tmp_path, monkeypatch, marks_made, stamping):
    """One DINO ViT step: the marks in `MARKS`' order, each kernel its own,
    each into its own column of the step's row; under a CPU profiler the
    ranges `phase.<mark>` in the same order inside `step 0`."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path)
    assert trainer.algorithm.marks == trace.MARKS
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    trainer._stamps = torch.zeros((trainer._epoch_idx.shape[0], len(trace.MARKS)),
                                  dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state)
    assert marks_made == list(trace.MARKS)
    assert stamping == [(i, i) for i in range(len(trace.MARKS))]
    assert trainer._stamps[0].tolist() == list(range(1, len(trace.MARKS) + 1))
    events = [(e.name, e.time_range.start) for e in prof.events()
              if e.name.startswith("phase.")]
    assert [n[len("phase."):] for n, _ in sorted(events, key=lambda e: e[1])] == list(
        trace.MARKS[:-1])


@pytest.mark.parametrize("algo", ["simclr", "byol"])
def test_simclr_and_byol_mark_no_student(algo, tmp_path, monkeypatch, marks_made, stamping):
    """Their steps make the seven marks of `STEP_MARKS`, no `student`, into
    the seven columns their stamps have, as before the mark was added."""
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path, algo)
    assert trainer.algorithm.marks == trace.STEP_MARKS and "student" not in trace.STEP_MARKS
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    trainer._stamps = torch.zeros((trainer._epoch_idx.shape[0], 7), dtype=torch.int64)
    trainer.step(state)
    assert marks_made == list(trace.STEP_MARKS)
    assert stamping == [(trace.MARKS.index(m), c) for c, m in enumerate(trace.STEP_MARKS)]
    assert (trainer._stamps[0] > 0).all()


def test_a_mark_the_step_does_not_make_raises():
    with trace.phases(None, torch.zeros((), dtype=torch.int64)):
        trace.phase("views")
        with pytest.raises(ValueError):
            trace.phase("student")


def test_phase_ms_splits_the_two_forwards():
    """An epoch's medians from DINO's eight columns: `forward` the teacher's
    (to `student`), `student` the student's (to `loss`)."""
    base = [0, 1_000_000, 3_000_000, 6_000_000, 6_500_000, 9_000_000, 9_200_000, 9_300_000]
    rows = [[t + 1 + 10_000_000 * s for t in base] for s in range(3)]
    got = trace.phase_ms(torch.tensor(rows, dtype=torch.int64), trace.MARKS)
    assert got == pytest.approx({"views": 1.0, "forward": 2.0, "student": 3.0, "loss": 0.5,
                                 "backward": 2.5, "optimizer": 0.2, "state": 0.1,
                                 "between": 0.7})


class _FakeGraph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("replays", [1, 3])
def test_work_counters_count_the_replays(replays, tmp_path, monkeypatch):
    """`train/graph.py`'s CUDA calls made to run on the CPU (the capture runs
    the step once, a replay runs nothing): after the three warm-up steps,
    the capture and `replays` more replays, `vit.tokens` and
    `multicrop.crops` have grown by (replays + 1) steps' counts since the
    capture, and the graph holds one step's."""
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
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tmp_path)
    trainer.epoch_mode = "graph"
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    before = {k: trace.counters.get(k, 0) for k in trace.WORK}
    for _ in range(graph_mod.WARMUP_STEPS):
        trainer.step(state)
    warm = {k: trace.counters.get(k, 0) - before[k] for k in trace.WORK}
    assert warm == {"vit.tokens": 3 * TOKENS_A_STEP, "multicrop.crops": 3 * CROPS_A_STEP}
    at_capture = {k: trace.counters.get(k, 0) for k in trace.WORK}
    for _ in range(replays + 1):
        trainer.step(state)
    assert trainer.graph.replays == replays + 1
    assert {k: trainer.graph.held[k] for k in trace.WORK} == {
        "vit.tokens": TOKENS_A_STEP, "multicrop.crops": CROPS_A_STEP}
    got = {k: trace.counters.get(k, 0) - at_capture[k] for k in trace.WORK}
    assert got == {"vit.tokens": (replays + 1) * TOKENS_A_STEP,
                   "multicrop.crops": (replays + 1) * CROPS_A_STEP}


# --------------------------------------------------------------------------
# the cell's readers
# --------------------------------------------------------------------------

READERS = ("dino_views_ms", "dino_teacher_ms", "dino_student_forward_ms", "dino_backward_ms",
           "dino_optimizer_ms", "mfu_dino_vit")
# one step's marks (us after the step's start), a kernel of 10 us after each
MARK_AT = {"views": 0, "forward": 300, "student": 400, "loss": 550, "backward": 560,
           "optimizer": 900, "state": 950, "end": 980}
WANT = {"dino_views_ms": 0.3, "dino_teacher_ms": 0.1, "dino_student_forward_ms": 0.15,
        "dino_backward_ms": 0.34, "dino_optimizer_ms": 0.05}


def _ops(skip=()):
    ops = []
    for s in range(3):
        t = 1000.0 * s
        for mark, at in MARK_AT.items():
            if mark not in skip:
                ops.append((f"ssv_mark_{mark}", t + at, t + at + 2))
            ops.append(("void kernel<float>(float*)", t + at + 3, t + at + 13))
    return ops


def _run(ops):
    return {"profile": {"steps": 3, "ops": ops, "host": [], "wall_s": 1.0},
            "unprofiled": {"images": 64 * 781, "seconds": 16.0},
            "peaks": {"bf16_flops": 989e12}, "flops_per_image": 1.6e10}


def test_the_cells_readers_read_the_marks():
    got = {name: harness.read_metric(name, _run(_ops())) for name in READERS}
    assert {k: got[k] for k in WANT} == pytest.approx(WANT)
    assert got["mfu_dino_vit"] == pytest.approx(100 * 1.6e10 * 64 * 781 / 16.0 / 989e12)


def test_the_cells_readers_read_nothing_without_the_marks():
    """No marks at all: every phase reader None (and `mfu_dino_vit` with no
    unprofiled part); marks without `student` (the program before it was
    added): the two forwards None, the others read."""
    bare = [op for op in _ops() if not op[0].startswith("ssv_mark_")]
    run = _run(bare)
    del run["unprofiled"]
    assert all(harness.read_metric(name, run) is None for name in READERS)
    old = {name: harness.read_metric(name, _run(_ops(skip=("student",)))) for name in READERS}
    assert old["dino_teacher_ms"] is None and old["dino_student_forward_ms"] is None
    assert old["dino_views_ms"] == pytest.approx(0.3)
    assert old["dino_backward_ms"] == pytest.approx(0.34)
