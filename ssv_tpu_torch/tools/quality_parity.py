"""The port's shapes100 quality rows held against the JAX package's.

JAX's rows (`VALIDATION.md`, transcribed with the rule into
`shapes100_jax.json` beside this file) against the port's rows
(`shapes100_port.json`, written by `--join ... --write`):

    python -m ssv_tpu_torch.tools.quality_parity

prints, for each port row, its KNN beside JAX's at each of JAX's curve
epochs, then the best KNN, the backbone KNN, the probe and the pseudo-label
entropies with their gaps, and the verdict by the rule in
`shapes100_jax.json` (its `rule.notes` say it in words). Exits 0 when every
row given passes, 1 on a miss or on a row that waits for its second seed.

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
FIELD = re.compile(r"(\w+)=(\S+)")

# the eval line's numbers kept per eval epoch (the runner's diagnostics)
DIAGNOSTICS = ("captures", "outside_s", "alloc_gib", "peak_gib")

ROW_KEYS = ("algo", "seed", "dataset", "epochs", "batch", "n_train", "n_test", "knn_curve",
            "best_knn", "final_knn", "linear", "img_per_sec", "wall_s", "calls")


def _number(text: str) -> float:
    return float(text.replace(",", ""))


def _parse_call(text: str, algo: str) -> dict:
    """One call's eval lines, dataset sizes and JSON row for `algo`."""
    evals, row, sizes, epochs = {}, None, None, None
    for line in text.splitlines():
        m = EVAL_LINE.match(line)
        if m and m["algo"] == algo and "knn=" in m["rest"]:
            fields = {k: _number(v) for k, v in FIELD.findall(m["rest"])
                      if k != "loss" and re.fullmatch(r"-?[\d,.]+(e-?\d+)?", v)}
            evals[int(m["epoch"])] = fields
            epochs = int(m["epochs"])
            continue
        m = RESOLVED.match(line)
        if m and m["algo"] == algo:
            sizes = (m["name"], int(_number(m["train"])), int(_number(m["test"])))
            continue
        if line.startswith("{"):
            r = json.loads(line)
            if r.get("algo") == algo:
                row = r
    return {"evals": evals, "row": row, "sizes": sizes, "epochs": epochs}


def expected_epochs(epochs: int, eval_every: int) -> list[int]:
    """The runner's eval epochs: every `eval_every`-th and the last."""
    return [e for e in range(1, epochs + 1) if e % eval_every == 0 or e == epochs]


def join(algo: str, texts: list[str], eval_every: int) -> dict:
    """One row of `algo` from its calls' logs, in call order."""
    calls = [_parse_call(t, algo) for t in texts]
    merged, epochs, sizes = {}, None, None
    for i, call in enumerate(calls):
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
    missing = sorted(set(expected_epochs(epochs, eval_every)) - set(merged))
    if missing:
        raise ValueError(f"{algo}: eval epoch(s) {missing} missing from the logs")
    last = calls[-1]["row"]
    if last is None or "error" in last:
        raise ValueError(f"{algo}: the last call printed no row (cut before its probe?): "
                         f"{last}")
    done = [c["row"] for c in calls if c["row"] is not None and "error" not in c["row"]]
    curve = [[e, merged[e]["knn"]] for e in sorted(merged)]
    row = {
        "algo": algo, "seed": last.get("seed", 420), "dataset": sizes[0] if sizes else None,
        "epochs": epochs, "batch": last["batch"],
        "n_train": sizes[1] if sizes else None, "n_test": sizes[2] if sizes else None,
        "knn_curve": curve, "best_knn": max(k for _, k in curve), "final_knn": curve[-1][1],
        "linear": last["linear"],
        "img_per_sec": max(r["img_per_sec"] for r in done),
        "wall_s": sum(r["wall_s"] for r in done), "calls": len(texts),
    }
    backbone = [[e, merged[e]["knn_backbone"]] for e in sorted(merged)
                if "knn_backbone" in merged[e]]
    if backbone:
        row["knn_backbone_curve"] = backbone
        row["best_knn_backbone"] = max(k for _, k in backbone)
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
    return {"seed": row["seed"], "gaps": gaps, "below": below, "above": above,
            "collapsed": collapsed, "fails": bool(below or collapsed)}


def judge(jax_row: dict, rows: list[dict], rule: dict) -> dict:
    """The verdict on one algorithm's port rows (one per seed): "pass",
    "miss" or "open" (a seed the rule needs is not run yet)."""
    r = _rule_for(jax_row, rule)
    for row in rows:
        if (row["epochs"], row["n_train"], row["n_test"]) != (
                jax_row["epochs"], jax_row["n_train"], jax_row["n_test"]):
            raise ValueError(f"{row['algo']} seed {row['seed']}: run at {row['epochs']} "
                             f"epochs on {row['n_train']}/{row['n_test']}, JAX's at "
                             f"{jax_row['epochs']} on {jax_row['n_train']}/{jax_row['n_test']}")
    seeds = [_seed_result(jax_row, row, r) for row in sorted(rows, key=lambda x: x["seed"])]
    failed = [s for s in seeds if s["fails"]]
    if r["kind"] == "high" or any(not s["fails"] for s in seeds):
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
    out = [f"== {jax_row['algo']}: {jax_row['epochs']} epochs, batch {jax_row['batch']} "
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
        out.append(f"  {key:<20} JAX {_fmt(want)}  port " + ", ".join(
            f"s{x['seed']} {_fmt(g)} ({'—' if d is None else f'{d:+.4f}'})"
            for x, g, d in zip(rows, got, gaps)))
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
    """Every port row beside JAX's: (exit code, text)."""
    text, verdicts = [], {}
    for jax_row in jax["rows"]:
        algo = jax_row["algo"]
        rows = [r for r in port_rows if r["algo"] == algo]
        if not rows:
            text.append(f"== {algo}: not run (JAX best KNN {jax_row['best_knn']})")
            continue
        result = judge(jax_row, rows, jax["rule"])
        verdicts[algo] = result["verdict"]
        text.append(report(jax_row, rows, result))
    summary = ", ".join(f"{a} {v}" for a, v in verdicts.items()) or "no row given"
    text.append(f"verdicts: {summary}")
    return (0 if verdicts and all(v == "pass" for v in verdicts.values()) else 1), "\n".join(text)


def write_row(path: str, row: dict) -> None:
    """Puts `row` into the port file, replacing the row of its algo and seed."""
    data = load(path) if os.path.exists(path) else {
        "about": "The port's shapes100 rows, as `python -m "
                 "ssv_tpu_torch.tools.quality_parity --join` read them from the runner's "
                 "logs; judged against shapes100_jax.json by the same tool.", "rows": []}
    data["rows"] = [r for r in data["rows"]
                    if (r["algo"], r["seed"]) != (row["algo"], row["seed"])] + [row]
    order = [r["algo"] for r in load(JAX_PATH)["rows"]]
    data["rows"].sort(key=lambda r: (order.index(r["algo"]) if r["algo"] in order
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
    jax_row = next((r for r in jax["rows"] if r["algo"] == algo), None)
    every = args.eval_every or (jax_row["knn_curve"][0][0] if jax_row else 0)
    if not every:
        ap.error(f"--eval-every is needed: JAX has no {algo} row")
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    row = join(algo, texts, every)
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
        raise ValueError(f"JAX has no {algo} row to judge against")
    print(json.dumps(row))
    if args.write:
        write_row(PORT_PATH, row)
    result = judge(jax_row, [row], jax["rule"])
    print(report(jax_row, [row], result))
    return 0 if result["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
