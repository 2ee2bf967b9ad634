"""The port's shapes100 quality rows held against the JAX package's.

JAX's rows (`VALIDATION.md`, transcribed with the rule into
`shapes100_jax.json` beside this file) against the port's rows
(`shapes100_port.json`, written by `--join ... --write`):

    python -m ssv_tpu_torch.tools.quality_parity

prints, for each port row, its KNN beside JAX's at each of JAX's curve
epochs, then the best KNN, the backbone KNN, the probe and the pseudo-label
entropies with their gaps (those the rule does not judge marked so), each
eval's teacher-probe `mi` and loss where a row carries them, and the verdict
by the rule in `shapes100_jax.json` (its `rule.notes` say it in words).
Exits 0 when every JAX row has port rows and they pass, 1 on a miss, on a
row that waits for its second seed, and on a JAX row the port has not run.

A row is read from the saved stdout of `python -m
ssv_tpu_torch.tools.quality_run`, one log per call in call order (a row
carried over calls with `--resume` restarts its curve at the resumed
epoch):

    python -m ssv_tpu_torch.tools.quality_parity --join swav c1.log c2.log \\
        --card "$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)" \\
        --commit <commit> --write

joins the curve from every call's eval lines (`[algo/dataset] epoch e/E
... knn=...`) and takes the probe from the last call's JSON line; it raises
on a missing eval epoch, on two calls that disagree about one epoch, and on
a last call that printed no row. `--keys-only` checks a joined row's keys
and curve and judges nothing (a short smoke row).

A row is one algorithm on one backbone with one set of `--set` overrides:
every row names its `arch` and `overrides`, the join takes them from the
runner's `[<algo>] row: {...}` line (and raises on a log without it), and a
port row is written beside and judged against only the JAX row with the
same three. DINO on ResNet-18 with `teacher_update: step` and
`center_init: zeros` is one such row; a DINO row on the ViT is another, and
JAX has none on shapes100 to hold it against. Every JAX row ran its whole
horizon with finite losses, so a port row whose loss went non-finite (the
runner's `nan_at`) misses, whatever its KNN.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_PATH = os.path.join(HERE, "shapes100_jax.json")
PORT_PATH = os.path.join(HERE, "shapes100_port.json")

EVAL_LINE = re.compile(r"^\[(?P<algo>\w+)/(?P<dataset>\w+)\] epoch (?P<epoch>\d+)/"
                       r"(?P<epochs>\d+) (?P<rest>.*)$")
RESOLVED = re.compile(r"^\[(?P<algo>\w+)\] dataset resolved: (?P<name>\w+) "
                      r"\((?P<train>[\d,]+) train / (?P<test>[\d,]+) test\)")
ROW = re.compile(r"^\[(?P<algo>\w+)\] row: (?P<json>\{.*\})$")
FIELD = re.compile(r"(\w+)=(\S+)")

# the eval line's numbers kept per eval epoch (the runner's diagnostics)
DIAGNOSTICS = ("captures", "outside_s", "alloc_gib", "peak_gib")

ROW_KEYS = ("algo", "arch", "overrides", "seed", "dataset", "epochs", "batch", "n_train",
            "n_test", "knn_curve", "best_knn", "final_knn", "linear", "img_per_sec", "wall_s",
            "calls")


def row_key(row: dict) -> tuple:
    """(algo, arch, overrides) of a JAX or port row."""
    overrides = tuple(sorted((k, json.dumps(v)) for k, v in row["overrides"].items()))
    return row["algo"], row["arch"], overrides


def label(row: dict) -> str:
    """The row's name: its algorithm, then its backbone and overrides where
    it has overrides or a backbone other than resnet18
    (`dino[resnet18 center_init=zeros]`, `dino[vit]`)."""
    algo, arch, overrides = row_key(row)
    if arch == "resnet18" and not overrides:
        return algo
    return f"{algo}[{' '.join([arch] + [f'{k}={json.loads(v)}' for k, v in overrides])}]"


def _number(text: str) -> float:
    return float(text.replace(",", ""))


def _parse_call(text: str, algo: str) -> dict:
    """One call's eval lines, dataset sizes, backbone and overrides, and
    JSON row for `algo`."""
    evals, row, sizes, epochs, named = {}, None, None, None, {}
    for line in text.splitlines():
        m = EVAL_LINE.match(line)
        if m and m["algo"] == algo and "knn=" in m["rest"]:
            fields = {k: _number(v) for k, v in FIELD.findall(m["rest"])
                      if re.fullmatch(r"-?[\d,.]+(e-?\d+)?", v)}
            evals[int(m["epoch"])] = fields
            epochs = int(m["epochs"])
            continue
        m = RESOLVED.match(line)
        if m and m["algo"] == algo:
            sizes = (m["name"], int(_number(m["train"])), int(_number(m["test"])))
            continue
        m = ROW.match(line)
        if m and m["algo"] == algo:
            named = json.loads(m["json"])
            continue
        if line.startswith("{"):
            r = json.loads(line)
            if r.get("algo") == algo:
                row = r
    return {"evals": evals, "row": row, "sizes": sizes, "epochs": epochs, "named": named}


def expected_epochs(epochs: int, eval_every: int) -> list[int]:
    """The runner's eval epochs: every `eval_every`-th and the last."""
    return [e for e in range(1, epochs + 1) if e % eval_every == 0 or e == epochs]


def join(algo: str, texts: list[str], eval_every: int) -> dict:
    """One row of `algo` from its calls' logs, in call order."""
    calls = [_parse_call(t, algo) for t in texts]
    merged, epochs, sizes, named = {}, None, None, {}
    for i, call in enumerate(calls):
        if call["named"]:
            if named and named != call["named"]:
                raise ValueError(f"{algo}: calls ran {named} and {call['named']}")
            named = call["named"]
        for e, fields in call["evals"].items():
            if e in merged:
                same = all(merged[e].get(k) == fields.get(k) for k in ("knn", "knn_backbone"))
                if not same:
                    raise ValueError(f"{algo}: calls disagree at epoch {e}: {merged[e]} "
                                     f"against {fields} (call {i + 1})")
            merged[e] = fields
        if call["epochs"] is not None:
            if epochs not in (None, call["epochs"]):
                raise ValueError(f"{algo}: calls ran {epochs} and {call['epochs']} epochs")
            epochs = call["epochs"]
        sizes = call["sizes"] or sizes
    if epochs is None:
        raise ValueError(f"{algo}: no eval line in {len(texts)} log(s)")
    if not named:
        raise ValueError(f"{algo}: no log names the row's backbone and overrides (the "
                         f"runner's `[{algo}] row:` line)")
    last = calls[-1]["row"]
    if last is None or "error" in last:
        raise ValueError(f"{algo}: the last call printed no row (cut before its probe?): "
                         f"{last}")
    # a non-finite loss ends the run: its evals stop there, its KNN is the row's
    nan_at = last.get("nan_at")
    if nan_at is not None:
        merged[nan_at] = {"knn": dict(map(tuple, last["knn_curve"]))[nan_at]}
    want = [e for e in expected_epochs(epochs, eval_every) if nan_at is None or e < nan_at]
    missing = sorted(set(want) - set(merged))
    if missing:
        raise ValueError(f"{algo}: eval epoch(s) {missing} missing from the logs")
    done = [c["row"] for c in calls if c["row"] is not None and "error" not in c["row"]]
    curve = [[e, merged[e]["knn"]] for e in sorted(merged)]
    row = {
        "algo": algo, "arch": named["arch"], "overrides": named["overrides"],
        "seed": last.get("seed", 420), "dataset": sizes[0] if sizes else None,
        "epochs": epochs, "batch": last["batch"],
        "n_train": sizes[1] if sizes else None, "n_test": sizes[2] if sizes else None,
        "knn_curve": curve, "best_knn": max(k for _, k in curve), "final_knn": curve[-1][1],
        "linear": last["linear"],
        "img_per_sec": max(r["img_per_sec"] for r in done),
        "wall_s": sum(r["wall_s"] for r in done), "calls": len(texts),
    }
    if nan_at is not None:
        row["nan_at"] = nan_at
    backbone = [[e, merged[e]["knn_backbone"]] for e in sorted(merged)
                if "knn_backbone" in merged[e]]
    if backbone:
        row["knn_backbone_curve"] = backbone
        row["best_knn_backbone"] = max(k for _, k in backbone)
    for key, name in (("t_mi", "teacher_mi_curve"), ("loss", "loss_curve")):
        curve = [[e, merged[e][key]] for e in sorted(merged) if key in merged[e]]
        if curve:
            row[name] = curve
    entropies = [r for r in done if r.get("pseudo_entropy_min") is not None]
    if entropies:
        row.update(pseudo_entropy_min=min(r["pseudo_entropy_min"] for r in entropies),
                   pseudo_entropy_last=last["pseudo_entropy_last"],
                   half_log_K=last["half_log_K"])
    diag = [[e] + [merged[e].get(k) for k in DIAGNOSTICS] for e in sorted(merged)
            if any(k in merged[e] for k in DIAGNOSTICS)]
    if diag:
        row["diagnostics"] = {"columns": ["epoch", *DIAGNOSTICS], "rows": diag}
    return row


def check_keys(row: dict, eval_every: int) -> None:
    """A joined row's keys and curve (no quality judged): raises if wrong."""
    missing = [k for k in ROW_KEYS if k not in row]
    if missing:
        raise ValueError(f"{row.get('algo')}: the joined row lacks {missing}")
    want = expected_epochs(row["epochs"], eval_every)
    if [e for e, _ in row["knn_curve"]] != want:
        raise ValueError(f"{row['algo']}: curve epochs {row['knn_curve']}, want {want}")
    values = [k for _, k in row["knn_curve"]] + [row["linear"]]
    if not all(isinstance(v, float | int) and 0.0 <= v <= 1.0 for v in values):
        raise ValueError(f"{row['algo']}: a KNN or the probe outside [0, 1]: {values}")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _rule_for(jax_row: dict, rule: dict) -> dict:
    """The margin, judged numbers and seeds of `jax_row`'s class of row."""
    if jax_row["best_knn"] >= rule["high_bar"]:
        return dict(rule["high"], kind="high")
    judged = [jax_row.get("judge_on", "best_knn")]
    return dict(rule["other"], judged=judged, kind="other")


def _seed_result(jax_row: dict, row: dict, r: dict) -> dict:
    """One seed's gaps on the judged numbers, what falls below or rises
    above by more than the margin, and the entropy check."""
    below, above, gaps = [], [], {}
    for key in r["judged"]:
        want, got = jax_row.get(key), row.get(key)
        if want is None:
            continue
        if got is None:
            below.append(f"{key} missing")
            continue
        gap = round(got - want, 4)
        gaps[key] = gap
        if gap < -r["margin"]:
            below.append(f"{key} {got} is {gap:+.4f} from JAX's {want}")
        elif gap > r["margin"]:
            above.append(f"{key} {got} is {gap:+.4f} above JAX's {want}")
    collapsed = None
    if jax_row.get("half_log_K") is not None:
        bar = row.get("half_log_K", jax_row["half_log_K"])
        low = row.get("pseudo_entropy_min")
        if low is None or not low > bar:
            collapsed = f"pseudo-label entropy min {low} not above the bar {bar}"
    nan_at = row.get("nan_at")
    if nan_at is not None:
        below.append(f"loss non-finite at epoch {nan_at} (JAX's stayed finite)")
    return {"seed": row["seed"], "gaps": gaps, "below": below, "above": above,
            "collapsed": collapsed, "nan_at": nan_at, "fails": bool(below or collapsed)}


def judge(jax_row: dict, rows: list[dict], rule: dict) -> dict:
    """The verdict on one row's port rows (one per seed): "pass", "miss"
    (also at once where a seed's loss went non-finite) or "open" (a seed the
    rule needs is not run yet)."""
    r = _rule_for(jax_row, rule)
    for row in rows:
        if (row["epochs"], row["n_train"], row["n_test"]) != (
                jax_row["epochs"], jax_row["n_train"], jax_row["n_test"]):
            raise ValueError(f"{row['algo']} seed {row['seed']}: run at {row['epochs']} "
                             f"epochs on {row['n_train']}/{row['n_test']}, JAX's at "
                             f"{jax_row['epochs']} on {jax_row['n_train']}/{jax_row['n_test']}")
        if row_key(row) != row_key(jax_row):
            raise ValueError(f"{label(row)} seed {row['seed']} is not JAX's {label(jax_row)} "
                             f"row: another algorithm, backbone or override")
    seeds = [_seed_result(jax_row, row, r) for row in sorted(rows, key=lambda x: x["seed"])]
    failed = [s for s in seeds if s["fails"]]
    if any(s["nan_at"] is not None for s in seeds):
        verdict = "miss"
    elif r["kind"] == "high" or any(not s["fails"] for s in seeds):
        verdict = "miss" if r["kind"] == "high" and failed else "pass"
    else:
        ran = {s["seed"] for s in seeds}
        verdict = "miss" if set(r["seeds"]) <= ran else "open"
    return {"algo": jax_row["algo"], "verdict": verdict, "rule": r, "seeds": seeds}


def _fmt(v) -> str:
    return "—" if v is None else f"{v:.4f}" if isinstance(v, float) else str(v)


def report(jax_row: dict, rows: list[dict], result: dict) -> str:
    """The row beside JAX's, as text."""
    rows = sorted(rows, key=lambda x: x["seed"])
    r = result["rule"]
    out = [f"== {label(jax_row)}: {jax_row['epochs']} epochs, batch {jax_row['batch']} "
           f"(JAX: {jax_row['section']}, VALIDATION.md:{jax_row['line']}); margin "
           f"{r['margin']} on {', '.join(r['judged'])}"]
    out.append("  epoch   JAX     " + "  ".join(f"port s{x['seed']}" for x in rows))
    for e, k in jax_row["knn_curve"]:
        port = [dict(map(tuple, x["knn_curve"])).get(e) for x in rows]
        out.append(f"  {e:>5}  {k:.4f}   " + "     ".join(_fmt(p) for p in port))
    for key in ("best_knn", "best_knn_backbone", "linear", "pseudo_entropy_min",
                "pseudo_entropy_last"):
        want = jax_row.get(key)
        got = [x.get(key) for x in rows]
        if want is None and all(g is None for g in got):
            continue
        gaps = [None if g is None or want is None else round(g - want, 4) for g in got]
        name = key if key in r["judged"] else f"{key} (not judged)"
        out.append(f"  {name:<20} JAX {_fmt(want)}  port " + ", ".join(
            f"s{x['seed']} {_fmt(g)} ({'—' if d is None else f'{d:+.4f}'})"
            for x, g, d in zip(rows, got, gaps)))
    for curve in ("teacher_mi_curve", "loss_curve"):
        want = dict(map(tuple, jax_row.get(curve, [])))
        for x in rows:
            if want or x.get(curve):
                pairs = " ".join(f"{e}:{_fmt(v)}/{_fmt(want.get(e))}" for e, v in x.get(curve, []))
                out.append(f"  {curve} s{x['seed']} (port/JAX, not judged): {pairs or '—'}")
    for x in rows:
        out.append(f"  s{x['seed']}: {x.get('img_per_sec')} img/s (best epoch), "
                   f"{x.get('wall_s')} s, {x.get('card', 'card not recorded')}, "
                   f"commit {x.get('commit', '—')}")
    for s in result["seeds"]:
        for note in s["below"] + ([s["collapsed"]] if s["collapsed"] else []):
            out.append(f"  s{s['seed']} below: {note}")
        for note in s["above"]:
            out.append(f"  s{s['seed']} above (reported, not a miss): {note}")
    out.append(f"  verdict: {result['verdict'].upper()}")
    return "\n".join(out)


def judge_all(jax: dict, port_rows: list[dict]) -> tuple[int, str]:
    """Every port row beside JAX's: (exit code, text). A JAX row with no
    port row ("not_run"), and a port row with no JAX row of its algorithm,
    backbone and overrides ("unmatched"), are named and fail the exit code."""
    text, verdicts = [], {}
    for jax_row in jax["rows"]:
        rows = [r for r in port_rows if row_key(r) == row_key(jax_row)]
        if not rows:
            text.append(f"== {label(jax_row)}: not run (JAX best KNN {jax_row['best_knn']})")
            verdicts[label(jax_row)] = "not_run"
            continue
        result = judge(jax_row, rows, jax["rule"])
        verdicts[label(jax_row)] = result["verdict"]
        text.append(report(jax_row, rows, result))
    keys = {row_key(j) for j in jax["rows"]}
    for r in port_rows:
        if row_key(r) not in keys:
            text.append(f"== {label(r)} seed {r['seed']}: JAX has no such row")
            verdicts[label(r)] = "unmatched"
    summary = ", ".join(f"{a} {v}" for a, v in verdicts.items()) or "no row given"
    text.append(f"verdicts: {summary}")
    return (0 if verdicts and all(v == "pass" for v in verdicts.values()) else 1), "\n".join(text)


def write_row(path: str, row: dict) -> None:
    """Puts `row` into the port file, replacing the row of its algorithm,
    backbone, overrides and seed."""
    data = load(path) if os.path.exists(path) else {
        "about": "The port's shapes100 rows, as `python -m "
                 "ssv_tpu_torch.tools.quality_parity --join` read them from the runner's "
                 "logs; judged against shapes100_jax.json by the same tool.", "rows": []}
    data["rows"] = [r for r in data["rows"]
                    if (row_key(r), r["seed"]) != (row_key(row), row["seed"])] + [row]
    order = [row_key(r) for r in load(JAX_PATH)["rows"]]
    data["rows"].sort(key=lambda r: (order.index(row_key(r)) if row_key(r) in order
                                     else len(order), r["seed"]))
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.tools.quality_parity")
    ap.add_argument("--join", nargs="+", metavar=("ALGO", "LOG"),
                    help="join ALGO's row from its calls' logs, in call order")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="the runner's --eval-every (default: JAX's curve spacing)")
    ap.add_argument("--keys-only", action="store_true",
                    help="check the joined row's keys and curve, judge nothing")
    ap.add_argument("--card", default=None, help="nvidia-smi's name and power limit")
    ap.add_argument("--commit", default=None, help="the commit the row ran on")
    ap.add_argument("--write", action="store_true",
                    help="put the joined row into shapes100_port.json")
    args = ap.parse_args(argv)
    jax = load(JAX_PATH)
    if not args.join:
        rows = load(PORT_PATH)["rows"] if os.path.exists(PORT_PATH) else []
        rc, text = judge_all(jax, rows)
        print(text)
        return rc

    algo, logs = args.join[0], args.join[1:]
    if not logs:
        ap.error("--join needs ALGO and at least one log")
    spacings = {r["knn_curve"][0][0] for r in jax["rows"] if r["algo"] == algo}
    every = args.eval_every or (spacings.pop() if len(spacings) == 1 else 0)
    if not every:
        ap.error(f"--eval-every is needed: JAX's {algo} rows give no one spacing")
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    row = join(algo, texts, every)
    jax_row = next((r for r in jax["rows"] if row_key(r) == row_key(row)), None)
    if args.card:
        row["card"] = args.card
    if args.commit:
        row["commit"] = args.commit
    if args.keys_only:
        check_keys(row, every)
        print(json.dumps(row))
        print(f"[quality_parity] {algo}: the joined row's keys and its curve "
              f"{[e for e, _ in row['knn_curve']]} are whole; quality not judged")
        return 0
    if jax_row is None:
        raise ValueError(f"JAX has no {label(row)} row to judge against")
    print(json.dumps(row))
    if args.write:
        write_row(PORT_PATH, row)
    result = judge(jax_row, [row], jax["rule"])
    print(report(jax_row, [row], result))
    return 0 if result["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
