"""The comparison that decides `correct`, on the first steps of a training
run: the program's against the plain reference's, from the same weights,
images, index rows and augmentation draws.

Three numbers, each a gap relative to the reference:

  * `loss`: the largest |program - reference| / |reference| of a step's
    loss, over the checked steps;
  * `grad`: the first step's gradient, by the worst leaf: the gap between
    the program's norm of a leaf and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf;
  * `change`: the parameters' change over the checked steps (after - the
    starting weights), by the worst leaf, the same way.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias in front of a BatchNorm, which the normalisation cancels)
have a gradient and a change of round-off alone, and are left out of both;
a tower that trains by no gradient (BYOL's target) is judged by the rule
on its trained counterpart's leaf.
"""

from __future__ import annotations

import statistics

import torch

NUMBERS = ("loss", "grad", "change")
QUIET = 1e-3   # a leaf whose reference gradient is under this x the median's is left out


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of the leaf and of the median leaf."""
    names = list(names)
    ref_n = {n: _norm(ref[n]) for n in names}
    floor = statistics.median(ref_n.values())
    return {n: abs(_norm(prog[n]) - ref_n[n]) / max(ref_n[n], floor, 1e-30) for n in names}


def _worst(gaps: dict) -> tuple[float, str]:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def counted(ref_grad: dict, names) -> list[str]:
    """The leaves whose change is compared (module docstring)."""
    norms = {n: _norm(g) for n, g in ref_grad.items()}
    floor = QUIET * statistics.median(norms.values())

    def trained(n):
        return n if n in norms else "model." + n.split(".", 1)[1]

    return [n for n in names if norms.get(trained(n), 0.0) >= floor]


def gaps(prog: dict, ref: dict, start: dict) -> tuple[list, dict, dict]:
    """(each step's loss gap, each counted leaf's first-gradient gap, each
    counted leaf's change gap) for the program's and the reference's
    {"losses", "first_grad", "params"}; `start` the weights both began
    from (on any device). The leaves are the reference's parameters: a
    weight marked as a state buffer (`inputs.buffers`) is never one."""
    if len(prog["losses"]) != len(ref["losses"]) or not ref["losses"]:
        raise ValueError("the two sides checked different steps")
    loss = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"],
                     counted(ref["first_grad"], ref["first_grad"]))
    names = list(ref["params"])
    start = {n: start[n].detach().float().cpu() for n in names}
    delta_p = {n: prog["params"][n].cpu() - start[n] for n in names}
    delta_r = {n: ref["params"][n].float().cpu() - start[n] for n in names}
    change = leaf_gaps(delta_p, delta_r, counted(ref["first_grad"], names))
    return loss, grad, change


def numbers(prog: dict, ref: dict, start: dict) -> dict:
    """{number: (value, the leaf or step it comes from)} (`gaps`' worst)."""
    loss, grad, change = gaps(prog, ref, start)
    step = max(range(len(loss)), key=loss.__getitem__)
    out = {"loss": (loss[step], f"step {step + 1}"), "grad": _worst(grad),
           "change": _worst(change)}
    for k, (v, _) in out.items():
        if v != v:   # a NaN never passes a limit
            out[k] = (float("inf"), out[k][1])
    return out


def details(prog: dict, ref: dict, start: dict) -> dict:
    """What `numbers` takes the worst of, more widely, for setting limits:
    each step's loss gap, and the median counted leaf's gap of the first
    gradient and of the change."""
    loss, grad, change = gaps(prog, ref, start)
    return {"loss_steps": loss, "grad_median": statistics.median(grad.values()),
            "change_median": statistics.median(change.values())}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell's limits name within its limit, {number:
    {"value", "limit"}}). A number the limits leave out has no reading
    that a fault or the control gives above the sound runs', and is not
    judged."""
    checks = {k: {"value": nums[k][0], "limit": float(limits[k]["limit"])}
              for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
