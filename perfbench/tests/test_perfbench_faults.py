"""A run with the timed path broken underneath comes out not correct: the
harness driven as on the card (the look for a card skipped), on the CPU at
a small size, with the port in float32 and each fault planted in it. The
cell is on one card, so no exchange between cards can be left out."""

import pytest
import torch

from perfbench.tests import tiny

CELLS = ["simclr_r18_b512", "byol_r18_b512"]


def _frozen(monkeypatch):
    """The step returns the state unchanged: no optimizer update."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)


def _half(monkeypatch):
    """Half of the batch left out, the loss the mean over the rest."""
    from ssv_tpu_torch.train.algorithms import byol, simclr

    for cls in (simclr.SimCLR, byol.BYOL):
        step = cls.train_step

        def halved(self, state, batch, generator=None, _step=step):
            n = batch["aug_1"].shape[0] // 2
            return _step(self, state, {k: v[:n] for k, v in batch.items()}, generator)

        monkeypatch.setattr(cls, "train_step", halved)


def _update_altered(monkeypatch):
    """One answer altered where it is produced: the first parameter's
    gradient doubled before the update."""
    step = torch.optim.SGD.step

    def altered(self, closure=None):
        p = self.param_groups[0]["params"][0]
        p.grad.mul_(2.0)
        return step(self, closure)

    monkeypatch.setattr(torch.optim.SGD, "step", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert tiny.measure(cell)["correct"] is True


@pytest.mark.parametrize("fault", [_frozen, _half, _update_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.measure(cell)
    assert res["correct"] is False, res["checks"]


def _frozen_from_the_fourth_step(monkeypatch):
    """The state left unchanged from the fourth step on, as a replayed
    step that runs nothing would leave it (the first three steps run
    eagerly before the step is captured)."""
    step, calls = torch.optim.SGD.step, []

    def late(self, closure=None):
        calls.append(1)
        return step(self, closure) if len(calls) <= 3 else None

    monkeypatch.setattr(torch.optim.SGD, "step", late)


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_later_steps_is_not_correct(cell, monkeypatch):
    _frozen_from_the_fourth_step(monkeypatch)
    res = tiny.measure(cell)
    assert res["correct"] is False, res["checks"]
