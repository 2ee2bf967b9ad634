"""The phase readers (`phases.py`, `metrics/phase_*_ms.py`,
`metrics/setup_*_s.py`): on hand-written device op lists, the phases'
intervals and their sum, a missing `loss` mark merged into `forward`, the
marks' cost, and nothing read where nothing is marked; the set-up readers
read the port's span ring and nothing without it. On the card (`card`):
the trainer's own stamps against the profiler's phases of the same steps at
each cell's size, the phases' sum against the profiled device span, and
replays bit for bit the eager steps with the marks captured."""

import math
import statistics
import sys
import types

import pytest
import torch

from perfbench import devtrace, harness, inputs, phases, program
from perfbench.tests import tiny

CELLS = ["simclr_r18_b512", "byol_r18_b512"]
# one step, its marks' starts (us after the step's start); a kernel of 10 us
# after each mark, and the position's advance after `end`; a step each 1000 us
MARK_AT = {"views": 0, "forward": 100, "loss": 400, "backward": 450, "optimizer": 900,
           "state": 950, "end": 980}


def _ops(steps=3, skip=()):
    ops = []
    for s in range(steps):
        t = 1000.0 * s
        for mark, at in MARK_AT.items():
            if mark in skip:
                continue
            ops.append((f"ssv_mark_{mark}", t + at, t + at + 2))
            ops.append(("void kernel<float>(float*)", t + at + 3, t + at + 13))
        ops.append(("at::native::add", t + 990, t + 995))
    return ops


def test_phase_intervals_and_their_sum():
    ops = _ops()
    got = phases.phase_ms(ops)
    assert got == pytest.approx({"views": 0.1, "forward": 0.3, "loss": 0.05, "backward": 0.45,
                                 "optimizer": 0.05, "state": 0.03, "between": 0.02})
    assert sum(got.values()) == pytest.approx(1.0)
    span = devtrace.span_us(ops) / 3 / 1e3
    assert abs(sum(got.values()) / span - 1) < 0.01
    spans = phases.intervals(ops)
    assert len(spans["views"]) == 3 and len(spans["between"]) == 2
    # views: the mark (2 us) and a kernel (10 us) busy of its 100 us
    assert phases.busy_ms(ops, spans["views"]) == pytest.approx(0.012)


def test_a_missing_loss_mark_stays_in_forward():
    got = phases.phase_ms(_ops(skip=("loss",)))
    assert "loss" not in got and got["forward"] == pytest.approx(0.35)
    assert sum(got.values()) == pytest.approx(1.0)


def test_marks_cost():
    """A step of `_ops`: each mark's 2 us and the idle 1 us after it (7 x 3
    us), and the idle time before each mark since the last op ended (87,
    287, 37, 437, 37 and 17 us; 5 us before `views` after the first step)."""
    assert phases.mark_cost_ms(_ops()) == pytest.approx([0.923, 0.928, 0.928])


def _run(ops, steps=3):
    return {"profile": {"steps": steps, "ops": ops, "host": [], "wall_s": 1.0}}


@pytest.mark.parametrize("phase", phases.PHASES)
def test_readers_read_their_phase(phase, capsys):
    value = harness.read_metric(f"phase_{phase}_ms", _run(_ops()))
    assert value == pytest.approx(phases.phase_ms(_ops())[phase])
    assert f"phase_{phase}_ms" in capsys.readouterr().out


@pytest.mark.parametrize("name", [f"phase_{p}_ms" for p in phases.PHASES])
def test_readers_read_nothing_without_marks(name):
    unmarked = [op for op in _ops() if not op[0].startswith(phases.PREFIX)]
    assert harness.read_metric(name, _run(unmarked)) is None
    assert harness.read_metric(name, {"profile": None}) is None
    assert harness.read_metric(name, {}) is None
    assert phases.mark_cost_ms(unmarked) is None


def test_setup_readers(monkeypatch):
    """The sums of the `setup.*` spans and of `graph.warmup` and
    `graph.capture` from the port's ring; None without the module (the
    parent's program) or without its spans."""
    ring = [("setup.config", None, 0, 10**9), ("setup.state", None, 10**9, 3 * 10**9),
            ("graph.warmup", None, 0, 5 * 10**8), ("graph.capture", None, 0, 2 * 10**8),
            ("begin_epoch", None, 0, 7 * 10**9)]
    monkeypatch.setitem(sys.modules, "ssv_tpu_torch.utils.trace",
                        types.SimpleNamespace(spans=ring))
    assert harness.read_metric("setup_trainer_s", {}) == pytest.approx(3.0)
    assert harness.read_metric("setup_graph_s", {}) == pytest.approx(0.7)
    monkeypatch.setitem(sys.modules, "ssv_tpu_torch.utils.trace",
                        types.SimpleNamespace(spans=[]))
    assert harness.read_metric("setup_trainer_s", {}) is None
    monkeypatch.delitem(sys.modules, "ssv_tpu_torch.utils.trace")
    assert harness.read_metric("setup_trainer_s", {}) is None
    assert harness.read_metric("setup_graph_s", {}) is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _trainer(cell, seed, device):
    data = inputs.images(cell.traffic, seed, device)
    trainer = program.build(cell.config_path, cell.cfg, data, inputs.streams(seed)["draws"],
                            device, cell.overrides)
    program.load_weights(trainer, inputs.weights(cell.specs, seed, device))
    trainer.state = trainer.algorithm.pre_train(trainer.state, trainer)
    return trainer


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_stamps_agree_with_the_profiler(name, card, capsys):
    """At the cell's size in graph mode, an epoch to warm up and capture,
    then an epoch under the profiler: each phase of the epoch's record
    (`Trainer.phase_ms`, the median over its steps from the stamps) is
    within max(2 %, 5 us) of the median over the same steps of the
    intervals between the mark kernels' starts on the profiler's timeline
    (a median, so a mark the profiler drops at the edge of its window moves
    neither), and the phases' means summed are within 1 % of the profiled
    device span a step. Prints the `%globaltimer` tick seen (the stamps'
    greatest common step), the marks seen of each kind and their cost."""
    from torch.profiler import ProfilerActivity, profile

    def say(msg):
        with capsys.disabled():
            print(f"[phases] {name} {msg}")

    trainer = _trainer(harness.Cell(name), 2**40 + 17, card)
    state = trainer.state
    trainer._run_epoch(state, trainer.epoch_indices())
    assert trainer.epoch_mode == "graph" and trainer.graph.replays > 0
    idx = trainer.epoch_indices()
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._run_epoch(state, idx)
        torch.cuda.synchronize(card)
    ops, _ = devtrace.from_profiler(prof)
    seen = {m: sum(op[0].startswith(phases.PREFIX + m) for op in ops) for m in phases.MARKS}
    say(f"epoch of {idx.shape[0]} steps, {len(ops)} device ops; marks seen {seen}")
    stamps = trainer._stamps.cpu()
    tick = math.gcd(*(int(x) for x in (stamps[:, 1:] - stamps[:, :-1]).flatten().tolist()))
    say(f"%globaltimer tick {tick} ns")
    assert set(trainer.phase_ms) == set(phases.PHASES)
    spans = phases.intervals(ops)
    for phase, ms in trainer.phase_ms.items():
        prof_ms = statistics.median(b - a for a, b in spans[phase]) / 1e3
        say(f"{phase}: stamps {ms:.4f} ms, profiler {prof_ms:.4f} ms")
        assert abs(ms - prof_ms) <= max(0.02 * prof_ms, 0.005), (phase, ms, prof_ms)
    marked = len(phases.steps(ops))
    summed = sum(phases.phase_ms(ops).values())
    span = devtrace.span_us(ops) / marked / 1e3
    cost = phases.mark_cost_ms(ops)
    say(f"{marked} steps marked: the phases' sum {summed:.4f} ms, the device span a step "
        f"{span:.4f} ms; the marks' cost a step: median {statistics.median(cost):.4f} ms, "
        f"mean {sum(cost) / len(cost):.4f} ms")
    assert marked >= idx.shape[0] - 1 and abs(summed / span - 1) < 0.01


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_replays_equal_eager_steps_with_the_marks(name, card):
    """The tiny cell in float32 on the card, cuDNN deterministic: eight
    steps eagerly and in graph mode (three eager warm-up steps, the capture
    and replays, the marks in the graph), the losses and the weights bit
    for bit, the stamps of every step written in both."""
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for mode in ("step", "graph"):
            trainer = _trainer(tiny.cell(name), 2**33 + 5, card)
            trainer.epoch_mode = mode
            trainer.begin_epoch(trainer.epoch_indices())
            for _ in range(8):
                trainer.step(trainer.state)
            assert (trainer._stamps[:8] > 0).all()
            runs.append((trainer._metric_bufs["loss"][:8].cpu(), program.params(trainer)))
            if mode == "graph":
                assert trainer.graph.replays == 5
    finally:
        torch.backends.cudnn.deterministic = False
    (loss_a, params_a), (loss_b, params_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
