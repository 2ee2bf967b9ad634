"""The port's bench (`python -m ssv_tpu_torch.bench`) and its two tools
(`tools/bench_augment.py`, `tools/profile_report.py`) on the CPU: the
recipe, images and index matrices are bench.py's; six bench steps across
the schedule's end equal JAX's `_mini_simclr` steps on the same views; the
step's FLOP count equals one made from the shapes; the entry points print
their lines, and fail as bench.py fails without a device."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _mini_simclr
from ssv_tpu.data.augment import build_transform as jax_build_transform
from ssv_tpu.train.algorithms.simclr import SimCLR as JSimCLR
from ssv_tpu_torch import bench
from torch_helpers import assert_state_matches, load_jax_state, small_resnet18, t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", **extra)
    for key in ("SSV_BENCH_CPU", "SSV_BENCH_STEPS", "SSV_BENCH_NTRAIN", "SSV_BENCH_BATCH"):
        if key not in extra:
            env.pop(key, None)
    return env


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k != "transforms":
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# keys of configs/simclr.yaml that neither SimCLR nor its trainer step reads
# (`momentum` and `nesterov`: both packages hard-code SGD's 0.9 Nesterov)
UNREAD = {"eval_every", "linear_eval.epochs", "linear_eval.input_dim",
          "linear_eval.batch_size", "linear_eval.lr", "wandb.project", "data.root",
          "optimizer.momentum", "optimizer.nesterov"}


def test_recipe_is_mini_simclrs():
    """The bench trainer's config holds every key of `_mini_simclr`'s with
    its value, its transforms are `_mini_simclr`'s, and every other key it
    holds is one neither algorithm reads; the algorithm's sizes (images,
    batch, steps an epoch) and learning-rate schedule are JAX's; the
    trainer trains on the bench's images."""
    jalgo, jtransforms = _mini_simclr(batch_size=16, n_train=200)
    cfg, transforms = bench.mini_simclr(16, 200)
    assert transforms == jtransforms
    trainer = bench.build_trainer(16, 200, "cpu")
    want, got = _flat(jalgo.config), _flat(trainer.config)
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) == UNREAD | {"data.transforms"}
    assert got["data.transforms"] == jtransforms
    assert _flat(cfg) == want
    assert trainer.algorithm.total_steps == jalgo.data.steps_per_epoch == 12
    assert (trainer.data_info.n_train, trainer.data_info.batch_size) == (200, 16)
    assert trainer.epoch_mode == "step" and trainer.algorithm.autocast_dtype == torch.bfloat16
    jlr, tlr = jalgo.lr_fn(), trainer.algorithm.lr_fn()
    for s in range(30):
        assert abs(tlr(s) - float(jlr(s))) <= 1e-7, s
    images, labels = trainer.pipeline.arrays("train")
    assert torch.equal(images, torch.from_numpy(bench.bench_images(200)))
    assert images.dtype == torch.uint8 and not labels.any()


def test_images_are_bench_pys():
    """bench.py's draw (bench.py:200-202), bit for bit."""
    rng = np.random.RandomState(0)
    want = rng.randint(0, 256, size=(8192, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(bench.bench_images(8192), want)


def _jax_idx_mat(perm, steps, batch, n_train):
    """bench.py's `idx_mat_for` (bench.py:230-234) on a given permutation."""
    reps = -(-steps * batch // n_train)
    flat = jnp.concatenate([perm] * reps)[: steps * batch]
    return np.asarray(flat.reshape(steps, batch))


@pytest.mark.parametrize("steps,batch,n_train", [(100, 512, 8192), (7, 300, 1000),
                                                 (3, 8, 32), (2, 16, 32)])
def test_index_matrix_is_idx_mat_for(steps, batch, n_train):
    """Given the same permutation, the index matrix is `idx_mat_for`'s; the
    port's own permutation of an epoch is one of the images, fixed by the
    epoch's seed."""
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(steps), n_train))
    got = bench.index_matrix(torch.from_numpy(perm.astype(np.int64)), steps, batch)
    np.testing.assert_array_equal(got.numpy(), _jax_idx_mat(jnp.asarray(perm), steps, batch,
                                                            n_train))
    own = bench.epoch_permutation(1, n_train)
    assert sorted(own.tolist()) == list(range(n_train))
    assert torch.equal(own, bench.epoch_permutation(1, n_train))
    assert not torch.equal(own, bench.epoch_permutation(0, n_train))


PARITY_BATCH, PARITY_N, PARITY_STEPS = 8, 32, 3   # 4 steps an epoch: six cross it


def test_six_bench_steps_match_jax_across_the_schedule_end(monkeypatch):
    """Two bench epochs of 3 steps at B = 8 on 32 images, float32 compute, on
    a two-stage ResNet: JAX's `_mini_simclr` step (bench.py's
    `train_step`, its key splits and `idx_mat_for`) against the port's
    `Trainer.step` from the same weights, handed JAX's views for the index
    row the trainer read. The recipe's 4-step schedule ends after step 3:
    the learning rate equals JAX's at every step and is the cosine's end
    value, 0, at steps 4 and 5. Losses within 1e-5 relative at every step;
    after the six steps params within 1e-4 (the SimCLR step test's float32
    tolerance) and BN running statistics within 5e-5: JAX against itself,
    its params perturbed by 1e-7 relative before each step (the reference
    run at the end), parts in them by about 2.8e-5 after these six steps,
    so 1e-5, which holds for two, is below JAX's own float32 noise here.

    The base lr is 0.001, not the recipe's 0.5 (whose schedule
    `test_recipe_is_mini_simclrs` holds), for conditioning: at 0.5 the
    steps on 8 images are ill-conditioned for JAX itself (its own losses
    part far beyond 1e-5 under that perturbation), and at the SimCLR step
    test's 0.003 step 2 meets a layer-1 pre-activation within 1e-6 of 0,
    where float32 rounding decides whether its gradient passes the ReLU."""
    small_resnet18(monkeypatch)
    B, N, S = PARITY_BATCH, PARITY_N, PARITY_STEPS
    jalgo0, transforms = _mini_simclr(batch_size=B, n_train=N)
    optimizer = {**jalgo0.config["optimizer"], "lr": 0.001}
    jalgo = JSimCLR({**jalgo0.config, "compute_dtype": "float32", "optimizer": optimizer},
                    "resnet18", jalgo0.data)
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    jstate0, jbatches = jstate, []
    train_t = jax_build_transform(transforms["train"])
    images = bench.bench_images(N)
    jimages = jnp.asarray(images)

    @jax.jit
    def views(idx, key):
        raw = jnp.take(jimages, idx, axis=0)
        k1, k2, ka = jax.random.split(key, 3)
        return (jax.vmap(train_t)(jax.random.split(k1, B), raw),
                jax.vmap(train_t)(jax.random.split(k2, B), raw), ka)

    jstep = jax.jit(jalgo.train_step)
    jlr = jalgo.lr_fn()

    trainer = bench.build_trainer(B, N, "cpu", {"compute_dtype": "float32",
                                                "optimizer": optimizer})
    state = trainer.state
    load_jax_state(state, jstate, "simclr")
    state.scheduler.reserve(2 * S)
    drawn = {}

    def batch_fn(images_t, labels, idx, generator):
        np.testing.assert_array_equal(idx.numpy(), drawn["idx"])
        return {"index": idx, "img": images_t[idx].float() / 255.0,
                "aug_1": t(drawn["aug_1"]), "aug_2": t(drawn["aug_2"]),
                "label": labels[idx]}

    monkeypatch.setattr(trainer, "_batch_fn", batch_fn)
    step = 0
    for epoch in range(2):
        perm = jax.random.permutation(jax.random.PRNGKey(epoch), N)
        idx_mat = _jax_idx_mat(perm, S, B, N)
        trainer.begin_epoch(bench.index_matrix(torch.from_numpy(np.array(perm)).long(), S, B))
        for s, key in enumerate(jax.random.split(jax.random.PRNGKey(epoch), S)):
            aug_1, aug_2, ka = views(jnp.asarray(idx_mat[s]), key)
            drawn.update(idx=idx_mat[s], aug_1=np.asarray(aug_1), aug_2=np.asarray(aug_2))
            jbatches.append(({"index": idx_mat[s], "aug_1": aug_1, "aug_2": aug_2,
                              "label": jnp.zeros((B,), jnp.int32)}, ka))
            jstate, jm = jstep(jstate, *jbatches[-1])
            trainer.step(state)
            want, got = float(jm["loss"]), trainer._metric_bufs["loss"][s].item()
            assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
            lr = state.optimizer.param_groups[0]["lr"].item()
            assert lr == pytest.approx(float(jlr(step)), abs=1e-7), step
            if step >= jalgo.data.steps_per_epoch:
                assert lr == float(jlr(step)) == 0.0, step
            step += 1
    assert state.step == int(state.counter) == int(jstate.step) == 2 * S
    assert_state_matches(state, jstate, "simclr", param_tol=1e-4, stat_tol=5e-5)

    # the reference run: JAX's six steps again, its params perturbed by 1e-7
    # relative before each; its BN statistics' spread stays inside 5e-5
    @jax.jit
    def perturbed(params, key):
        leaves, tree = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves))
        return jax.tree_util.tree_unflatten(tree, [
            p * (1 + 1e-7 * jax.random.normal(k, p.shape)) for p, k in zip(leaves, keys)])

    noisy = jstate0
    for i, args in enumerate(jbatches):
        noisy = noisy.replace(params=perturbed(noisy.params, jax.random.PRNGKey(100 + i)))
        noisy, _ = jstep(noisy, *args)
    spread = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
        jax.tree_util.tree_leaves(noisy.batch_stats),
        jax.tree_util.tree_leaves(jstate.batch_stats)))
    print(f"JAX's own BN statistics spread under the perturbation: {spread:.3e}")
    assert spread <= 5e-5, spread


def _shape_count(trainer, batch):
    """Hooks that record every convolution's shapes in the step, and a
    function giving the FLOPs the step's matrix products need from their
    shapes, forward and backward, by part."""
    convs = []

    def hook(module, args, out):
        fwd = 2 * out.shape[0] * out.shape[2] * out.shape[3] * module.weight.numel()
        # backward: the weight's gradient, and the input's where it needs one
        convs.append(fwd * (2 + args[0].requires_grad))

    model = trainer.state.model
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]

    def count():
        for h in handles:
            h.remove()
        # the head's linear layers (`heads._dense`, no module call) on each
        # view: forward, the weight's and the input's gradients
        head = sum(3 * 2 * batch * fc.in_features * fc.out_features for fc in model.proj.fc)
        # per view, the resized crop's two interpolation products (rows, then
        # columns) over 32x32x3 images; no gradient
        size = 32
        crop = 2 * (2 * batch * size * size * size * 3)
        # NT-Xent's (2B x proj) @ its transpose; backward a product for each
        # operand
        nt_xent = 3 * 2 * (2 * batch) ** 2 * trainer.config["proj_dim"]
        return {"convolutions": sum(convs), "head": 2 * head, "crop": 2 * crop,
                "nt_xent": nt_xent}

    return count


def test_step_flops_equal_a_count_from_the_shapes():
    """The bench's FLOP count of one step (`count_step_flops`, the eager
    step under `FlopCounterMode`) at B = 4 equals, exactly, a count made
    from the shapes of every product the step runs: each convolution and
    linear layer of both views' forwards (forward, the weight's gradient,
    and the input's gradient except for the first convolution, whose input
    needs none), the resized crop's two interpolation products a view, and
    NT-Xent's similarity forward and backward."""
    batch = 4
    trainer = bench.build_trainer(batch, 16, "cpu")
    trainer.begin_epoch(bench.index_matrix(bench.epoch_permutation(0, 16), 4, batch))
    count = _shape_count(trainer, batch)
    got = bench.count_step_flops(trainer, trainer.state)
    parts = count()
    assert got == sum(parts.values()), (got, parts)
    assert len(parts) == 4 and all(v > 0 for v in parts.values())


LINE_KEYS = {"metric", "value", "unit", "batch", "model_tflops_per_sec_per_chip", "mfu",
             "steps", "n_train", "mode", "flops_per_image", "flops_by", "final_loss",
             "peak_memory_gib", "capture_s", "replays", "photometric_launches", "card"}


def _bench(**env):
    return subprocess.run([sys.executable, "-m", "ssv_tpu_torch.bench"], cwd=REPO,
                          env=_env(**env), capture_output=True, text=True, timeout=300)


def test_bench_on_the_cpu_prints_its_line():
    """`SSV_BENCH_CPU=1` at B = 8, 2 steps, 32 images: exit 0 and, last,
    the line with every key, in step mode, mfu null, a finite loss."""
    proc = _bench(SSV_BENCH_CPU="1", SSV_BENCH_BATCH="8", SSV_BENCH_STEPS="2",
                  SSV_BENCH_NTRAIN="32")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "ssl_pretrain_images_per_sec_per_chip"
    assert (line["batch"], line["steps"], line["n_train"], line["mode"]) == (8, 2, 32, "step")
    assert line["value"] > 0 and np.isfinite(line["final_loss"])
    assert line["mfu"] is None and line["card"] == "cpu" and line["peak_memory_gib"] is None
    assert line["flops_by"] == "torch.utils.flop_counter"
    assert line["flops_per_image"] > 1.6e9
    assert line["model_tflops_per_sec_per_chip"] == pytest.approx(
        line["flops_per_image"] * line["value"] / 1e12)


def test_bench_without_a_card_fails_with_its_line():
    """Without `SSV_BENCH_CPU` on a machine with no card: bench.py's failure
    line (`bench_failed`, the error) last, exit 1; no CPU run in its place."""
    proc = _bench()
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] is None and line["error"] == "bench_failed"
    assert line["metric"] == "ssl_pretrain_images_per_sec_per_chip"
    assert "no CUDA device" in line["last_error"]


def test_bench_refuses_ranks(monkeypatch):
    """Under torchrun at more than one rank the bench fails."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert bench.main() == 1


AUGMENT_KEYS = {"two_view_pallas_us", "two_view_xla_us", "photometric_pallas_us",
                "photometric_xla_us", "geometric_tail_us", "full_step_us",
                "aug_share_of_step", "aug_share_of_step_pallas", "geo_tail_share_of_step"}


def test_bench_augment_cpu_smoke():
    """`bench_augment 4 --cpu` (BA_SCAN 1): every key of JAX's script, the
    kernel variants and their share null, the plain ones timed."""
    proc = subprocess.run([sys.executable, "-m", "ssv_tpu_torch.tools.bench_augment", "4",
                           "--cpu"], cwd=REPO, env=_env(BA_SCAN="1"), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert AUGMENT_KEYS <= set(out) and (out["batch"], out["scan"]) == (4, 1)
    for key in ("two_view_pallas_us", "photometric_pallas_us", "aug_share_of_step_pallas"):
        assert out[key] is None, key
    for key in AUGMENT_KEYS - {"two_view_pallas_us", "photometric_pallas_us",
                               "aug_share_of_step_pallas"}:
        assert out[key] > 0, key
    assert out["aug_share_of_step"] == pytest.approx(2 * out["two_view_xla_us"]
                                                     / out["full_step_us"])


def test_plain_transform_is_the_batch_transform_on_the_cpu():
    """On CPU images the composed plain variant and `build_batch_transform`
    (whose head takes the plain version there) give the same views from
    the same generator state."""
    from ssv_tpu_torch.data.augment import build_batch_transform
    from ssv_tpu_torch.tools import bench_augment

    cfg = bench_augment.configs()["full"]
    images = torch.from_numpy(bench.bench_images(6))
    a = bench_augment.plain_transform(cfg)(torch.Generator().manual_seed(3), images)
    b = build_batch_transform(cfg)(torch.Generator().manual_seed(3), images)
    assert torch.equal(a, b)


def _trace(tmp_path, events):
    path = tmp_path / "epoch2.rank0.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_profile_report_on_a_hand_written_trace(tmp_path):
    """Overlapping kernels, a copy, annotations on both timelines and host
    events: the wall, the union, the duty and the sums by kind are exact;
    annotations and host events are left out."""
    from ssv_tpu_torch.tools import profile_report

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    path = _trace(tmp_path, [
        ev("step 0", "user_annotation", 0, 1000),
        ev("aten::mm", "cpu_op", 0, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 5, 3),
        ev("step 0", "gpu_user_annotation", 90, 400),
        ev("Optimizer.step#SGD.step", "gpu_user_annotation", 100, 300),
        ev("sm90_xmma_gemm_bf16", "kernel", 100, 100),      # 100-200
        ev("void photometric_kernel<16>", "kernel", 150, 100),  # 150-250, overlaps
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 300, 20),  # 300-320
        ev("void elementwise_kernel", "kernel", 310, 40),   # 310-350
        ev("void batch_norm_collect_statistics", "kernel", 400, 100),  # 400-500
        {"ph": "s", "name": "ac2g", "ts": 5, "id": 1},
    ])
    out = profile_report.report(str(tmp_path))
    assert out["device_ops"] == 5
    assert out["wall_ms"] == pytest.approx(0.4)        # 100 to 500 µs
    assert out["busy_ms"] == pytest.approx(0.3)        # 100-250, 300-350, 400-500
    assert out["duty"] == pytest.approx(0.75)
    assert out["ms_by_kind"] == pytest.approx({
        "matmul and conv": 0.1, "photometric kernel": 0.1, "copies and casts": 0.02,
        "elementwise and other": 0.04, "normalisation": 0.1})
    assert out["ops_by_kind"] == {"matmul and conv": 1, "photometric kernel": 1,
                                  "copies and casts": 1, "elementwise and other": 1,
                                  "normalisation": 1}
    assert list(out["top_ms"])[-1] == "Memcpy DtoD (Device -> Device)"


def test_profile_report_without_device_ops_raises(tmp_path):
    """A trace of host events alone (a CPU run) raises, and says why."""
    from ssv_tpu_torch.tools import profile_report

    path = _trace(tmp_path, [{"ph": "X", "name": "epoch 2", "cat": "user_annotation",
                              "ts": 0, "dur": 10},
                             {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "ts": 1,
                              "dur": 5}])
    with pytest.raises(RuntimeError, match="no device op"):
        profile_report.report(path)
    with pytest.raises(FileNotFoundError):
        profile_report.report(str(tmp_path / "nothing-here"))
