"""The shapes100 parity tool (`ssv_tpu_torch.tools.quality_parity`) on the
CPU: its transcription of the JAX package's rows against `VALIDATION.md`'s
tables, its rule on hand-made rows, the join of a row carried over calls,
a tiny `quality_run --dataset shapes100` cut into two calls and read back,
and the committed port rows against the rule and `ROADMAP.md`'s faults."""

import ast
import copy
import json
import os
import re

import pytest
import torch

from ssv_tpu_torch.tools import quality_parity as qp
from ssv_tpu_torch.tools import quality_run
from ssv_tpu_torch.train import trainer as trainer_mod

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = qp.load(qp.JAX_PATH)
with open(os.path.join(REPO, "scripts", "quality_run.py")) as _f:
    # the JAX runner's default backbone by algorithm (resnet18 otherwise)
    JAX_ARCH = ast.literal_eval(re.search(r"^ARCH = (\{.*?\})", _f.read(), re.M).group(1))
JAX_ROWS = {r["algo"]: r for r in JAX["rows"]}   # one JAX row an algorithm so far


def _validation_lines():
    with open(os.path.join(REPO, "VALIDATION.md")) as f:
        return f.read().splitlines()


def _number_or_none(cell: str):
    m = re.search(r"\d+(\.\d+)?", cell)
    return None if cell.strip().startswith("—") or m is None else float(m.group(0))


@pytest.mark.parametrize("algo", list(JAX_ROWS))
def test_jax_rows_equal_validation_md(algo):
    """Each transcribed row equals the markdown table row it names: the
    section heading and its dataset line (sizes, epochs), the algorithm,
    batch, KNN curve, best KNN, backbone KNN, probe, and for SeLA and
    DeepCluster the entropy line below the table."""
    lines = _validation_lines()
    row = JAX_ROWS[algo]
    assert lines[row["section_line"] - 1] == f"## Quality run: {row['section']}"
    info = next(ln for ln in lines[row["section_line"]:row["line"]] if "dataset `" in ln)
    m = re.search(r"`shapes100 \(([\d,]+) train / ([\d,]+) test\)`, (\d+) epochs", info)
    assert [int(x.replace(",", "")) for x in m.groups()] == [
        row["n_train"], row["n_test"], row["epochs"]]
    header = next(ln for ln in reversed(lines[:row["line"] - 1]) if ln.startswith("| algorithm"))
    names = [c.strip() for c in header.strip("|").split("|")]
    cells = dict(zip(names, (c.strip() for c in lines[row["line"] - 1].strip("|").split("|"))))
    assert cells["algorithm"].split()[0] == algo
    assert int(cells["batch"]) == row["batch"]
    curve = [[int(e), float(k)] for e, k in (p.split(":") for p in cells["KNN curve (epoch: acc)"].split())]
    assert curve == row["knn_curve"]
    assert float(cells["best KNN"]) == row["best_knn"] == max(k for _, k in curve)
    assert _number_or_none(cells.get("backbone KNN (best)", "—")) == row["best_knn_backbone"]
    assert _number_or_none(cells["linear"]) == row["linear"]
    for key in ("img/s/chip", "wall"):
        assert key in cells and key not in row   # no speed of the JAX run is carried
    if "entropy_line" in row:
        m = re.search(rf"{algo}: pseudo-label entropy min ([\d.]+) / last ([\d.]+) \(collapse "
                      r"bar 0\.5·log K = ([\d.]+)\)", lines[row["entropy_line"] - 1])
        assert [float(x) for x in m.groups()] == [
            row["pseudo_entropy_min"], row["pseudo_entropy_last"], row["half_log_K"]]
    # the run's overrides as its dataset line gives them; the backbone: the
    # JAX runner's default, or another that the section's reading names
    overrides = re.search(r"overrides (\{.*\})\.", info)
    assert (eval(overrides.group(1)) if overrides else {}) == row["overrides"]
    if row["arch"] != JAX_ARCH.get(algo, "resnet18"):
        reading = "\n".join(lines[row["line"]:row["line"] + 30])
        assert f"{row['arch']} backbone" in reading
    if "teacher_mi_curve" in row:
        probe = lines[row["teacher_probe_line"] - 1]
        assert probe.startswith(f"{algo} teacher-output probe")
        assert [[int(e), float(mi)] for e, mi in re.findall(r"ep(\d+): mi=([\d.]+)", probe)] == \
            row["teacher_mi_curve"]
    if "loss_curve" in row:
        text = lines[row["loss_line"] - 1]
        (held,) = {v for _, v in row["loss_curve"]}
        assert "No NaN in 1000 epochs" in text and f"loss held exactly {held}" in text
        assert [e for e, _ in row["loss_curve"]] == [e for e, _ in curve]


def _port(algo, seed=420, **values):
    """A port row of `algo` at JAX's horizon and sizes with JAX's numbers,
    then `values` in their place."""
    j = JAX_ROWS[algo]
    row = {"algo": algo, "seed": seed, "epochs": j["epochs"], "n_train": j["n_train"],
           "n_test": j["n_test"], "knn_curve": copy.deepcopy(j["knn_curve"]),
           "best_knn": j["best_knn"], "linear": j["linear"]}
    row.update({k: copy.deepcopy(j[k]) for k in ("arch", "overrides")})
    if j["best_knn_backbone"] is not None:
        row["best_knn_backbone"] = j["best_knn_backbone"]
    if "half_log_K" in j:
        row.update(pseudo_entropy_min=j["pseudo_entropy_min"],
                   pseudo_entropy_last=j["pseudo_entropy_last"], half_log_K=j["half_log_K"])
    row.update(values)
    return row


RULE_CASES = [
    # rows whose JAX best KNN is at or above 0.98: one seed, margin 0.02 on KNN and probe
    ("relic", [{"best_knn": 0.98, "linear": 0.98}], "pass", []),
    ("relic", [{"best_knn": 0.9799}], "miss", ["best_knn"]),
    ("barlow", [{"linear": 0.9796}], "miss", ["linear"]),
    ("simclr", [{"best_knn": 0.9672, "linear": 0.9596}], "pass", []),
    ("simclr", [{"best_knn": 0.9671}], "miss", ["best_knn"]),
    # the other rows: margin 0.05, a miss only where seeds 420 and 421 both fall below
    ("pirl", [{"best_knn": 0.7817}], "pass", []),
    ("pirl", [{"best_knn": 0.7816}], "open", ["best_knn"]),
    ("pirl", [{"best_knn": 0.7816}, {"seed": 421, "best_knn": 0.70}], "miss", ["best_knn"]),
    ("moco", [{"best_knn": 0.80}, {"seed": 421, "best_knn": 0.8463}], "pass", ["best_knn"]),
    ("moco", [{"best_knn": 0.9, "linear": 0.5}], "pass", []),   # the probe is not judged
    # a non-finite loss: a miss at once on any row, whatever the KNN before it
    ("pirl", [{"best_knn": 0.95, "nan_at": 640}], "miss", ["loss non-finite at epoch 640"]),
    ("byol", [{"best_knn_backbone": 0.99, "nan_at": 10}], "miss",
     ["loss non-finite at epoch 10"]),
    # BYOL and SimSiam judged on the backbone KNN alone
    ("byol", [{"best_knn": 0.05, "best_knn_backbone": 0.9110}], "pass", []),
    ("simsiam", [{"best_knn_backbone": 0.8}, {"seed": 421, "best_knn_backbone": 0.85}],
     "miss", ["best_knn_backbone"]),
    ("simsiam", [{"best_knn_backbone": None}], "open", ["best_knn_backbone missing"]),
    # DINO on ResNet-18 (step EMA, zero center): the backbone KNN with margin
    # 0.05, the full-path KNN reported; any non-finite loss a miss at once
    ("dino", [{"best_knn_backbone": 0.1358, "best_knn": 0.0}], "pass", []),
    ("dino", [{"best_knn_backbone": 0.1357}], "open", ["best_knn_backbone"]),
    ("dino", [{"best_knn_backbone": 0.10}, {"seed": 421, "best_knn_backbone": 0.12}], "miss",
     ["best_knn_backbone"]),
    ("dino", [{"best_knn_backbone": 0.30, "nan_at": 640}], "miss",
     ["loss non-finite at epoch 640"]),
    # the entropy bar: SeLA (a 0.98 row) and DeepCluster (another)
    ("sela", [{"pseudo_entropy_min": 2.426}], "miss", ["entropy"]),
    ("sela", [{"pseudo_entropy_min": 2.427}], "pass", []),
    ("deep_cluster", [{"pseudo_entropy_min": 1.0}], "open", ["entropy"]),
    ("deep_cluster", [{"pseudo_entropy_min": 1.0}, {"seed": 421, "pseudo_entropy_min": None}],
     "miss", ["entropy"]),
    # above JAX's by more than the margin: reported, a pass
    ("pirl", [{"best_knn": 0.95}], "pass", ["above"]),
    ("relic", [{"best_knn": 1.0, "linear": 1.0}], "pass", []),
]


@pytest.mark.parametrize("algo,seeds,verdict,notes", RULE_CASES)
def test_rule_on_hand_made_rows(algo, seeds, verdict, notes):
    """The verdict on hand-made rows at each margin's edge, with one seed
    and two, judged on the backbone KNN, under the entropy bar, and above
    JAX's; the report names what fell below or rose above."""
    rows = [_port(algo, **s) for s in seeds]
    result = qp.judge(JAX_ROWS[algo], rows, JAX["rule"])
    assert result["verdict"] == verdict
    text = qp.report(JAX_ROWS[algo], rows, result)
    assert f"verdict: {verdict.upper()}" in text
    for note in notes:
        if note == "above":
            assert "above (reported, not a miss)" in text
        elif note == "entropy":
            assert "pseudo-label entropy min" in text and " below: " in text
        else:
            assert f"below: {note}" in text
    if not notes:
        assert " below: " not in text and "above (reported" not in text


def test_rule_refuses_a_row_at_another_horizon():
    with pytest.raises(ValueError, match="run at 40 epochs"):
        qp.judge(JAX_ROWS["swav"], [_port("swav", epochs=40)], JAX["rule"])


@pytest.mark.parametrize("arch,overrides", [
    ("vit", {"teacher_update": "step", "center_init": "zeros"}),
    ("vit", {}),                                       # the runner's default
    ("resnet18", {"teacher_update": "step"}),
])
def test_a_dino_row_of_another_backbone_or_recipe_never_joins(arch, overrides, capsys):
    """A DINO port row on the ViT, or on ResNet-18 under another recipe, is
    not JAX's ResNet-18 row: `judge` refuses it, `judge_all` names it as
    having no JAX row and fails the exit code, and the JAX row stays not
    run; rows are told apart by `label`."""
    row = _port("dino", arch=arch, overrides=overrides)
    assert qp.row_key(row) != qp.row_key(JAX_ROWS["dino"])
    with pytest.raises(ValueError, match="is not JAX's dino"):
        qp.judge(JAX_ROWS["dino"], [row], JAX["rule"])
    rc, text = qp.judge_all(JAX, [row])
    assert rc == 1 and "JAX has no such row" in text
    assert "== dino[resnet18 center_init=zeros teacher_update=step]: not run" in text
    assert qp.label(JAX_ROWS["dino"]) == "dino[resnet18 center_init=zeros teacher_update=step]"
    assert qp.label(JAX_ROWS["simsiam"]) == "simsiam"
    assert qp.label(_port("dino", arch="vit", overrides={})) == "dino[vit]"


def _eval(algo, e, epochs, knn, extra=""):
    return f"[{algo}/shapes100] epoch {e}/{epochs} loss=1.0000 knn={knn} ips=1,000{extra}"


def _json(algo, **kw):
    row = {"algo": algo, "batch": 64, "linear": 0.5, "img_per_sec": 1000, "wall_s": 10}
    row.update(kw)
    return json.dumps(row)


RESOLVED = "[{a}] dataset resolved: shapes100 (256 train / 128 test)"


def _row_line(algo, arch="resnet18", overrides=None):
    return f"[{algo}] row: " + json.dumps({"arch": arch, "overrides": overrides or {}})


def test_join_two_calls():
    """A 4-epoch row cut after epoch 2's eval and resumed: the curve from
    both calls, the probe and entropies from the JSON lines, the wall summed,
    the best img/s, the diagnostics kept."""
    c1 = "\n".join([RESOLVED.format(a="sela"), _row_line("sela"),
                    _eval("sela", 1, 4, 0.1, " captures=1"),
                    _eval("sela", 2, 4, 0.2, " captures=1 outside_s=0.5 peak_gib=1.0"),
                    _eval("simclr", 3, 4, 0.9)])
    c2 = "\n".join([RESOLVED.format(a="sela"), _eval("sela", 3, 4, 0.4),
                    _eval("sela", 4, 4, 0.3, " knn_backbone=0.7"),
                    _json("sela", pseudo_entropy_min=2.0, pseudo_entropy_last=2.5,
                          half_log_K=1.0, resumed_at=3)])
    c0 = _json("sela", pseudo_entropy_min=1.5, pseudo_entropy_last=1.6, half_log_K=1.0,
               img_per_sec=2000, wall_s=5)
    row = qp.join("sela", [c1 + "\n" + c0, c2], 1)
    assert row["knn_curve"] == [[1, 0.1], [2, 0.2], [3, 0.4], [4, 0.3]]
    assert (row["best_knn"], row["final_knn"], row["linear"]) == (0.4, 0.3, 0.5)
    assert row["knn_backbone_curve"] == [[4, 0.7]] and row["best_knn_backbone"] == 0.7
    assert (row["pseudo_entropy_min"], row["pseudo_entropy_last"]) == (1.5, 2.5)
    assert (row["img_per_sec"], row["wall_s"], row["calls"]) == (2000, 15, 2)
    assert (row["n_train"], row["n_test"], row["seed"]) == (256, 128, 420)
    assert (row["arch"], row["overrides"]) == ("resnet18", {})
    assert row["diagnostics"]["rows"][:2] == [[1, 1.0, None, None, None], [2, 1.0, 0.5, None, 1.0]]
    qp.check_keys(row, 1)


@pytest.mark.parametrize("case,match", [
    ("gap", r"eval epoch\(s\) \[3\] missing"),
    ("disagree", "calls disagree at epoch 2"),
    ("no_row", "the last call printed no row"),
    ("other_horizon", "calls ran 4 and 5 epochs"),
    ("unnamed", "no log names the row's backbone and overrides"),
])
def test_join_raises(case, match):
    """A missing eval epoch, two calls that disagree about one epoch, a last
    call cut before its JSON line, calls of two horizons, logs that never
    name the row's backbone and overrides."""
    named = [] if case == "unnamed" else [_row_line("swav")]
    c1 = "\n".join(named + [_eval("swav", 1, 4, 0.1), _eval("swav", 2, 4, 0.2)])
    c2 = {"gap": [_eval("swav", 4, 4, 0.4), _json("swav")],
          "disagree": [_eval("swav", 2, 4, 0.25), _eval("swav", 3, 4, 0.3),
                       _eval("swav", 4, 4, 0.4), _json("swav")],
          "no_row": [_eval("swav", 3, 4, 0.3), _eval("swav", 4, 4, 0.4)],
          "other_horizon": [_eval("swav", 3, 5, 0.3), _json("swav")],
          "unnamed": [_eval("swav", 3, 4, 0.3), _eval("swav", 4, 4, 0.4), _json("swav")]}[case]
    with pytest.raises(ValueError, match=match):
        qp.join("swav", [c1, "\n".join(c2)], 1)


DINO_SET = {"teacher_update": "step", "center_init": "zeros"}
DINO_RESOLVED = "[dino] dataset resolved: shapes100 (20,480 train / 4,096 test)"


def _named(arch):
    return "[dino] row: " + json.dumps({"arch": arch, "overrides": DINO_SET})


def _dino_evals(last, backbone=0.17):
    return [_eval("dino", e, 1000, 0.02, f" knn_backbone={backbone} t_mi=0.00000 "
                  f"t_pstd=1.0e-07 captures=1").replace("loss=1.0000", "loss=13.8629")
            for e in range(100, last + 1, 100)]


def test_join_a_dino_resnet18_row(tmp_path, capsys):
    """A DINO ResNet-18 row's log: the join takes its backbone and overrides
    from the runner's `row:` line, keeps the teacher probe's `mi` and the loss at each
    eval, and the tool judges it against JAX's ResNet-18 row, reporting the
    full-path KNN, `mi` and the loss beside the judged backbone KNN."""
    log = tmp_path / "dino.log"
    log.write_text("\n".join([DINO_RESOLVED, _named("resnet18"), *_dino_evals(1000),
                              _json("dino", linear=0.01)]))
    assert qp.main(["--join", "dino", str(log)]) == 0
    out = capsys.readouterr().out
    row = json.loads(out.splitlines()[0])
    assert (row["arch"], row["overrides"], row["best_knn_backbone"]) == (
        "resnet18", DINO_SET, 0.17)
    assert row["teacher_mi_curve"] == [[e, 0.0] for e in range(100, 1001, 100)]
    assert row["loss_curve"][-1] == [1000, 13.8629]
    assert "== dino[resnet18 center_init=zeros teacher_update=step]: 1000 epochs, batch 64" in out
    assert "teacher_mi_curve s420 (port/JAX, not judged): 100:0.0000/0.0000" in out
    assert "loss_curve s420 (port/JAX, not judged): 100:13.8629/13.8629" in out
    assert "best_knn (not judged) JAX 0.0213  port s420 0.0200" in out
    assert "verdict: PASS" in out


def test_join_a_run_ended_by_a_non_finite_loss(tmp_path, capsys):
    """A run the runner ended at a non-finite loss (epoch 640): the curve
    stops there with that state's KNN, the row carries `nan_at`, and it
    misses, whatever its backbone KNN."""
    log = tmp_path / "dino.log"
    log.write_text("\n".join([
        DINO_RESOLVED, _named("resnet18"), *_dino_evals(600, backbone=0.3),
        "[dino/shapes100] epoch 640: loss=nan — non-finite state is terminal, aborting "
        "(knn=0.0100)",
        _json("dino", linear=None, nan_at=640,
              knn_curve=[[e, 0.02] for e in range(100, 601, 100)] + [[640, 0.01]])]))
    assert qp.main(["--join", "dino", str(log)]) == 1
    out = capsys.readouterr().out
    row = json.loads(out.splitlines()[0])
    assert row["nan_at"] == 640 and row["knn_curve"][-1] == [640, 0.01]
    assert row["linear"] is None and row["best_knn_backbone"] == 0.3
    assert "below: loss non-finite at epoch 640" in out and "verdict: MISS" in out


def test_join_refuses_a_vit_dino_log(tmp_path):
    """The join of a DINO run on the ViT finds no JAX row to judge it by."""
    log = tmp_path / "dino.log"
    log.write_text("\n".join([DINO_RESOLVED, _named("vit"), *_dino_evals(1000),
                              _json("dino")]))
    with pytest.raises(ValueError, match=r"JAX has no dino\[vit"):
        qp.main(["--join", "dino", str(log)])


class Cut(BaseException):
    """A call's end mid-run (not an `Exception`: the runner does not catch it)."""


def test_tiny_shapes100_row_over_two_calls(tmp_path, monkeypatch, capsys):
    """`quality_run --dataset shapes100 --device cpu` on `tiny`, 320 / 128
    images, 2 epochs: call 1 is cut at epoch 2's start (after epoch 1's eval
    saved `latest`), call 2 resumes; the tool joins both logs into a whole
    row (`--keys-only`), and the curve's epoch 1 is call 1's."""
    monkeypatch.chdir(tmp_path)
    argv = ["--algos", "swav", "--epochs", "2", "--eval-every", "1", "--dataset", "shapes100",
            "--n-train", "320", "--n-test", "128", "--batch", "64", "--arch", "tiny",
            "--set", "linear_eval.epochs=1", "--set", "feature_bank_size=128",
            "--set", "prototype_size=32", "--tag", "t", "--device", "cpu", "--no-write"]
    build = trainer_mod.build_algorithm

    def build_cut_at_2(*args, **kwargs):
        algo = build(*args, **kwargs)
        pre_epoch = algo.pre_epoch

        def cut(state, trainer, epoch):
            if epoch == 2:
                raise Cut
            return pre_epoch(state, trainer, epoch)

        algo.pre_epoch = cut
        return algo

    with monkeypatch.context() as m:
        m.setattr(trainer_mod, "build_algorithm", build_cut_at_2)
        with pytest.raises(Cut):
            quality_run.main(argv)
    logs = [tmp_path / "c1.log", tmp_path / "c2.log"]
    logs[0].write_text(capsys.readouterr().out)
    assert quality_run.main(argv + ["--resume"]) == 0
    logs[1].write_text(capsys.readouterr().out)
    assert "resumed from" in logs[1].read_text()

    rc = qp.main(["--join", "swav", *map(str, logs), "--eval-every", "1", "--keys-only"])
    out = capsys.readouterr().out
    assert rc == 0 and "quality not judged" in out
    row = json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
    e1 = re.search(r"epoch 1/2 .*knn=([\d.]+)", logs[0].read_text()).group(1)
    assert row["knn_curve"][0] == [1, float(e1)] and [e for e, _ in row["knn_curve"]] == [1, 2]
    assert (row["calls"], row["n_train"], row["n_test"], row["epochs"]) == (2, 320, 128, 2)
    assert (row["arch"], row["overrides"]) == ("tiny", {
        "linear_eval.epochs": 1, "feature_bank_size": 128, "prototype_size": 32})
    assert row["diagnostics"]["columns"] == ["epoch", "captures", "outside_s", "alloc_gib",
                                             "peak_gib"]
    assert all(r[1] == 0 for r in row["diagnostics"]["rows"])   # no graph on the CPU
    with pytest.raises(ValueError, match="JAX's at 300"):
        qp.judge(JAX_ROWS["swav"], [row], JAX["rule"])


def _roadmap_faults() -> str:
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    return text[text.index("### 3. Faults"):]


def test_committed_port_rows_pass_or_are_open_faults(capsys):
    """Each committed port row ran at the horizon, sizes, backbone and
    overrides of a JAX row on an H100 with its card line and commit; the
    tool exits 0 over them, or each JAX row whose port rows do not pass, or
    that has none, is listed in ROADMAP.md §3 as `shapes100 <label>`."""
    rows = qp.load(qp.PORT_PATH)["rows"]
    assert rows
    jax_rows = {qp.row_key(j): j for j in JAX["rows"]}
    assert len(jax_rows) == len(JAX["rows"])
    for r in rows:
        j = jax_rows[qp.row_key(r)]
        assert (r["epochs"], r["n_train"], r["n_test"], r["batch"]) == (
            j["epochs"], j["n_train"], j["n_test"], j["batch"]), r["algo"]
        assert "H100" in r["card"] and r["commit"], r["algo"]
    rc = qp.main([])
    out = capsys.readouterr().out
    last = out.splitlines()[-1]
    assert last.startswith("verdicts: ")
    verdicts = dict(v.rsplit(" ", 1) for v in last[len("verdicts: "):].split(", "))
    assert set(verdicts) == {qp.label(j) for j in JAX["rows"]}
    assert {qp.label(r) for r in rows} <= set(verdicts)
    faults = _roadmap_faults()
    assert rc == (0 if set(verdicts.values()) == {"pass"} else 1)
    for name, verdict in verdicts.items():
        assert verdict in ("pass", "miss", "open", "not_run"), name
        if verdict != "pass":
            assert f"shapes100 {name}" in faults, name
