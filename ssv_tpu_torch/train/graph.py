"""The epoch as one device program: the train step captured once as a CUDA
graph and replayed for every step of every epoch (the counterpart of the
JAX trainer's default, `jit_epoch`: a whole epoch as one jitted `lax.scan`,
one dispatch for the host).

The step the graph holds is `Trainer._train_step`: the step's index row
read at the epoch position, the batch gather, both views' augmentation
(the photometric kernel included), the forward and backward, the
optimizer update with the step's schedules read at the device counter,
the EMA and bank writes, the metrics written into the epoch's buffers and
the position advanced. Nothing in it reads the host, and every tensor it
reads or writes outside itself keeps its address: the parameters and the
optimizer's state (updated in place), the extra modules' buffers, the
epoch's index matrix and metric buffers (`Trainer.begin_epoch`).

  * The first `WARMUP_STEPS` steps of a trainer run eagerly on a side
    stream, the one stream of the device that every warm-up and capture
    runs on (`side_stream`). They are steps of the run, not extra ones:
    they build the photometric library, cuBLAS's workspace for that stream
    and cuDNN's plans, and the optimizer's state, which a captured step
    must find in place.
  * The next step is captured, with the trainer's device generator
    registered with the graph (`register_generator_state`), so each replay
    draws from the generator's offset at its launch and advances it, as the
    eager step would: replay k draws what eager step k draws, and a
    checkpoint's generator state counts the replays. The capture runs the
    step's Python once and no kernel, so the host's counts (`state.step`,
    the schedule's `taken`) are put back, and the graph is replayed for
    that same step and every later one, each replay advancing them by one.
  * The graph's memory pool holds the step's intermediates and the
    gradients the captured backward allocates; both go when the trainer
    drops the graph (a checkpoint load, whose optimizer state replaces the
    tensors the graph holds) or is itself dropped.
  * A failed capture or replay raises with its CUDA error: nothing falls
    back to the eager step.

Its counts and spans are in `utils/trace.py`: `graph.warmup_steps`,
`graph.captures` and `graph.replays`, and the recorded spans
`graph.warmup` (each warm-up step) and `graph.capture`; a replay is a span
`graph.replay` under a profiler only. The counters of `trace.REPLAYED`
(kernel launches and work done) are counted as the step's Python makes
them, so the capture's counts stand for the graph's first replay, and
every later replay adds the counts its capture held (`StepGraph.held`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..utils import trace

WARMUP_STEPS = 3


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a card's graph warm-ups and captures run on, one for the
    process (`cuda` and `cuda:<current>` alike): cuBLAS keeps a workspace
    (64 MiB on the H100) for every stream it ran on until the process
    ends, so a stream a trainer would keep one a trainer."""
    return _stream(torch.cuda.current_device() if device.index is None else device.index)


@lru_cache(maxsize=None)
def _stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(index)


class StepGraph:
    """One trainer's captured train step."""

    def __init__(self):
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warm = 0
        self.held = dict.fromkeys(trace.REPLAYED, 0)  # the counts the captured step holds
        self.replays = 0
        self.pool_bytes: int | None = None

    def step(self, trainer, state) -> None:
        """The trainer's next step: eager while warming up, then the capture
        and a replay, then replays."""
        if self.graph is not None:
            self._replay(state)
        elif self.warm < WARMUP_STEPS:
            with trace.span("graph.warmup", record=True):
                side = side_stream(trainer.device)
                side.wait_stream(torch.cuda.current_stream(trainer.device))
                with torch.cuda.stream(side):
                    trainer._train_step(state)
                torch.cuda.current_stream(trainer.device).wait_stream(side)
            self.warm += 1
            trace.count("graph.warmup_steps")
        else:
            with trace.span("graph.capture", record=True):
                self._capture(trainer, state)
            self._replay(state)

    def _capture(self, trainer, state) -> None:
        device = trainer.device
        torch.cuda.synchronize(device)
        # the warm-up's cached blocks back to the card, for the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(trainer.generator)
        step, taken = state.step, state.scheduler.taken
        before = {k: trace.counters.get(k, 0) for k in trace.REPLAYED}
        try:
            # thread_local: a process group's watchdog thread may query its
            # events meanwhile, and the step is all on this thread
            with torch.cuda.graph(graph, stream=side_stream(device),
                                  capture_error_mode="thread_local"):
                trainer._train_step(state)
        except Exception as err:
            raise RuntimeError(f"capturing the {trainer.algorithm.name} train step as a "
                               f"CUDA graph failed: {err}") from err
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        state.step, state.scheduler.taken = step, taken
        self.held = {k: trace.counters.get(k, 0) - n for k, n in before.items()}
        self.graph = graph
        trace.count("graph.captures")

    def _replay(self, state) -> None:
        with trace.span("graph.replay"):
            self.graph.replay()
        state.step += 1
        state.scheduler.taken += 1
        if self.replays:
            for k, n in self.held.items():
                if n:
                    trace.count(k, n)
        self.replays += 1
        trace.count("graph.replays")
