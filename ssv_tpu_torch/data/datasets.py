"""Dataset loading: CIFAR-10/100 from disk, with synthetic fallbacks.

The port's copy of ssv_tpu/data/datasets.py: the same readers of the
published CIFAR pickle and binary layouts, through the port's native IO
library (`data/native_io.py`: the binary reader and the pickle layout's
CHW -> HWC), the same `.raw` fast-start cache (read before any other
loader, written after a real read), and the same deterministic synthetic
sets (`make_synthetic`, synth100, shapes100), bit for bit.

Datasets are host numpy uint8 NHWC arrays; `DataPipeline` puts them on the
device once and assembles every batch there.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from dataclasses import dataclass

import numpy as np

from . import native_io

@dataclass
class SplitArrays:
    images: np.ndarray  # (N, H, W, 3) uint8
    labels: np.ndarray  # (N,) int32


@dataclass
class Dataset:
    name: str
    train: SplitArrays
    test: SplitArrays
    num_classes: int
    synthetic: bool = False


def _load_cifar_pickle_dir(d: str, coarse: bool = False):
    """Read the canonical CIFAR pickle layout (any of the two datasets)."""

    def read(fname):
        with open(fname, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        chw = entry["data"].reshape(-1, 3, 32, 32).astype(np.uint8)
        data = native_io.chw_to_hwc(chw)
        labels = entry.get("labels", entry.get("fine_labels"))
        return data, np.asarray(labels, np.int32)

    if os.path.exists(os.path.join(d, "data_batch_1")):  # cifar10
        xs, ys = zip(*[read(os.path.join(d, f"data_batch_{i}")) for i in range(1, 6)])
        train = SplitArrays(np.concatenate(xs), np.concatenate(ys))
        test = SplitArrays(*read(os.path.join(d, "test_batch")))
        return train, test, 10
    if os.path.exists(os.path.join(d, "train")):  # cifar100
        train = SplitArrays(*read(os.path.join(d, "train")))
        test = SplitArrays(*read(os.path.join(d, "test")))
        return train, test, 100
    raise FileNotFoundError(d)


def _load_cifar_binary_dir(d: str, name: str):
    """Read the published CIFAR *binary* layout
    (cifar-10-batches-bin / cifar-100-binary)."""
    if name == "cifar10":
        parts = [_read_cifar_binary(os.path.join(d, f"data_batch_{i}.bin"), 1, 10000)
                 for i in range(1, 6)]
        train = SplitArrays(np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts]))
        test = SplitArrays(*_read_cifar_binary(os.path.join(d, "test_batch.bin"), 1, 10000))
        return train, test, 10
    train = SplitArrays(*_read_cifar_binary(os.path.join(d, "train.bin"), 2, 50000))
    test = SplitArrays(*_read_cifar_binary(os.path.join(d, "test.bin"), 2, 10000))
    return train, test, 100


def _read_cifar_binary(path: str, label_bytes: int, max_n: int):
    """Rows of [label (1 or 2 bytes, fine label last)][3072 bytes CHW]."""
    return native_io.read_cifar_binary(path, label_bytes, max_n)


def _find_binary_dir(root: str, name: str):
    candidates = {"cifar10": ["cifar-10-batches-bin"],
                  "cifar100": ["cifar-100-binary"]}[name]
    probe = {"cifar10": "data_batch_1.bin", "cifar100": "train.bin"}[name]
    for base in (root, os.path.join(root, "..")) if root else ():
        for c in candidates:
            d = os.path.join(base, c)
            if os.path.isfile(os.path.join(d, probe)):
                return d
    return None


def _find_pickle_dir(root: str, name: str):
    candidates = {
        "cifar10": ["cifar-10-batches-py"],
        "cifar100": ["cifar-100-python"],
    }[name]
    for base in (root, os.path.join(root, "..")) if root else ():
        for c in candidates:
            d = os.path.join(base, c)
            if os.path.isdir(d):
                return d
        # maybe a tar archive sits there
        for tarname in (f"{c}.tar.gz" for c in candidates):
            t = os.path.join(base, tarname)
            if os.path.isfile(t):
                with tarfile.open(t) as tf:
                    tf.extractall(base)
                d = os.path.join(base, candidates[0])
                if os.path.isdir(d):
                    return d
    return None


def make_synthetic(name: str = "cifar10", num_classes: int = 10,
                   n_train: int = 50000, n_test: int = 10000,
                   image_size: int = 32, seed: int = 0) -> Dataset:
    """Class-structured synthetic images: each class is a smooth random RGB
    gradient field plus per-sample noise — enough signal that SSL encoders
    separate classes and KNN accuracy is a meaningful smoke metric."""
    rng = np.random.RandomState(seed)
    H = W = image_size
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / max(H - 1, 1)

    protos = []
    for c in range(num_classes):
        coef = rng.uniform(-1, 1, size=(3, 6)).astype(np.float32)
        fields = np.stack([
            coef[k, 0] + coef[k, 1] * xx + coef[k, 2] * yy + coef[k, 3] * xx * yy
            + coef[k, 4] * np.sin(3 * np.pi * xx * (1 + c / num_classes))
            + coef[k, 5] * np.cos(3 * np.pi * yy * (1 + c / num_classes))
            for k in range(3)], axis=-1)
        lo, hi = fields.min(), fields.max()
        protos.append((fields - lo) / max(hi - lo, 1e-6))
    protos = np.stack(protos)  # (C, H, W, 3)

    def split(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        labels = r.randint(0, num_classes, size=n).astype(np.int32)
        noise = r.normal(0, 0.15, size=(n, H, W, 3)).astype(np.float32)
        shift = r.uniform(-0.15, 0.15, size=(n, 1, 1, 3)).astype(np.float32)
        imgs = np.clip(protos[labels] + noise + shift, 0, 1)
        return SplitArrays((imgs * 255).astype(np.uint8), labels)

    return Dataset(name=name, train=split(n_train, 1), test=split(n_test, 2),
                   num_classes=num_classes, synthetic=True)


def make_synthetic_hard(name: str = "synth100", num_classes: int = 100,
                        n_train: int = 50000, n_test: int = 10000,
                        image_size: int = 32, seed: int = 0) -> Dataset:
    """Non-saturating synthetic benchmark (VERDICT round-1 item 1b).

    The easy synthetic set (make_synthetic) is near-linearly separable in
    pixel space — 3-epoch KNN pins at ~1.0 and cannot rank algorithms. Here
    the class signal is deliberately NOT visible to raw-pixel similarity:

      * a dictionary of T sinusoidal texture fields is SHARED by all
        classes; a class is defined only by which textures are active and
        with what channel weights (its power spectrum);
      * every instance redraws each texture's PHASE uniformly, so two
        images of the same class are pixel-wise nearly orthogonal — an
        encoder must learn phase-invariant (magnitude) statistics, which is
        exactly what conv feature detectors can do and raw KNN cannot;
      * 100 fine classes = 10 superclasses (which textures are active)
        x 10 fine variants (small weight perturbations + one extra weak
        texture), so ranking requires fine-grained distinctions;
      * per-instance brightness/color shifts and noise add further nuisance.

    Deterministic in `seed`. Chance KNN = 1/num_classes.
    """
    rng = np.random.RandomState(seed)
    H = W = image_size
    T = 24                      # shared texture dictionary size
    S = 4                       # active textures per superclass

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / max(H - 1, 1)
    freqs = rng.uniform(1.0, 6.0, size=(T, 2)).astype(np.float32)
    u = freqs[:, 0, None, None] * xx[None] + freqs[:, 1, None, None] * yy[None]
    b_sin = np.sin(2 * np.pi * u).astype(np.float32)   # (T, H, W)
    b_cos = np.cos(2 * np.pi * u).astype(np.float32)

    n_super = 10
    n_fine = num_classes // n_super
    A = np.zeros((num_classes, 3, T), np.float32)      # class -> channel weights
    for s in range(n_super):
        active = rng.choice(T, size=S, replace=False)
        base = rng.uniform(0.5, 1.0, size=(3, S)).astype(np.float32)
        base *= rng.choice([-1.0, 1.0], size=(3, S))
        for f in range(n_fine):
            c = s * n_fine + f
            A[c][:, active] = base * rng.uniform(0.8, 1.2, size=(3, S))
            extra = rng.randint(0, T)
            A[c][:, extra] += rng.uniform(0.2, 0.4) * rng.choice([-1.0, 1.0])

    def split(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        labels = r.randint(0, num_classes, size=n).astype(np.int32)
        imgs = np.empty((n, H, W, 3), np.uint8)
        for lo in range(0, n, 2048):
            hi = min(lo + 2048, n)
            m = hi - lo
            phase = r.uniform(0, 2 * np.pi, size=(m, T)).astype(np.float32)
            w1 = A[labels[lo:hi]] * np.cos(phase)[:, None, :]   # (m, 3, T)
            w2 = A[labels[lo:hi]] * np.sin(phase)[:, None, :]
            x = (np.einsum("mkt,thw->mhwk", w1, b_sin)
                 + np.einsum("mkt,thw->mhwk", w2, b_cos))
            x /= max(np.sqrt(S), 1.0) * 2.0                     # ~[-1, 1]
            x += r.uniform(-0.2, 0.2, size=(m, 1, 1, 3)).astype(np.float32)
            x += r.normal(0, 0.08, size=x.shape).astype(np.float32)
            imgs[lo:hi] = (np.clip(x * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
        return SplitArrays(imgs, labels)

    return Dataset(name=name, train=split(n_train, 1), test=split(n_test, 2),
                   num_classes=num_classes, synthetic=True)


def make_synthetic_shapes(name: str = "shapes100", num_classes: int = 100,
                          n_train: int = 50000, n_test: int = 10000,
                          image_size: int = 32, seed: int = 0) -> Dataset:
    """Augmentation-INVARIANT class structure (VERDICT round-2 item 1).

    synth100 ranks the contrastive/clustering families but collapses the
    negative-free (BYOL/SimSiam) family: its class signal (texture power
    spectra) is destroyed by the train augmentations, so the cheapest
    augmentation-invariant representation is a near-constant — a fixed
    point for methods with no repulsion term. This benchmark is the
    complement: class identity lives exactly in what the reference's
    train transforms (RRC / flip / color-jitter / grayscale,
    augmentations.py:113-126) PRESERVE, and instance nuisance lives
    exactly in what they destroy — so invariance-seeking methods are
    pushed *toward* the class signal (the reason BYOL works on CIFAR:
    byol.py:89,126-130 trains pure cross-view invariance).

      * a class is a fixed spatial arrangement of 3 geometric shapes
        (type, size, position per slot; 5 mirror-symmetric types: disc,
        ring, square, cross, diamond) — shape identity/size/layout
        survive crops, flips and any photometric op;
      * every instance redraws all colors (bright random shape colors on
        a dark random-gradient background — nuisance aligned with
        color-jitter/grayscale; luminance bands keep shapes visible
        after grayscale), re-jitters positions/scale within the RRC
        translation range, and mirrors the layout with p=0.5 (so the
        flip augmentation maps within-class);
      * 100 layouts drawn i.i.d. → fine-grained decisions between
        near-collision layouts; chance KNN = 1/num_classes = 0.01.

    Deterministic in `seed`.
    """
    rng = np.random.RandomState(seed + 7)
    H = W = image_size
    K = 3  # shapes per class
    scale = image_size / 32.0

    # class prototypes: (type, radius, cx, cy, texture type, texture freq)
    # per slot. Textures are the load-bearing class signal for the
    # negative-free family (diag runs A-E, VALIDATION.md): outline geometry
    # alone left BYOL at chance in BOTH this framework and a torch
    # reimplementation of the reference recipe, while CIFAR — where BYOL
    # demonstrably works — is texture-separable. Each shape's interior
    # carries a class-characteristic luminance texture from a
    # flip-symmetric family (h-stripes / v-stripes / rings / checker), with
    # the PHASE redrawn per instance: type survives crop/flip/photometric
    # ops exactly, frequency up to RRC zoom, phase is pure nuisance.
    ptype = rng.randint(0, 5, size=(num_classes, K))
    prad = rng.uniform(3.2, 6.2, size=(num_classes, K)).astype(np.float32) * scale
    ang = rng.uniform(0, 2 * np.pi, size=(num_classes, K)).astype(np.float32)
    dist = rng.uniform(2.5, 9.5, size=(num_classes, K)).astype(np.float32) * scale
    pcx = dist * np.cos(ang)
    pcy = dist * np.sin(ang)  # relative to image center
    ttype = rng.randint(0, 4, size=(num_classes, K))
    tfreq = rng.uniform(0.18, 0.40, size=(num_classes, K)).astype(np.float32) / scale

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    xx -= (W - 1) / 2.0
    yy -= (H - 1) / 2.0
    aa = 1.1  # anti-alias width (px)

    def sdf(t, dx, dy, r):
        """Signed distance per shape type; all five are mirror-symmetric."""
        ax, ay = np.abs(dx), np.abs(dy)
        rr = np.sqrt(dx * dx + dy * dy)
        out = np.where(t == 0, rr - r, 0.0)                              # disc
        out = np.where(t == 1, np.abs(rr - 0.78 * r) - 0.30 * r, out)    # ring
        out = np.where(t == 2, np.maximum(ax, ay) - 0.85 * r, out)       # square
        cross = np.minimum(np.maximum(ax - 0.32 * r, ay - r),
                           np.maximum(ax - r, ay - 0.32 * r))
        out = np.where(t == 3, cross, out)                               # cross
        out = np.where(t == 4, (ax + ay) - 1.15 * r, out)                # diamond
        return out

    def split(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        labels = r.randint(0, num_classes, size=n).astype(np.int32)
        imgs = np.empty((n, H, W, 3), np.uint8)
        for lo in range(0, n, 1024):
            hi = min(lo + 1024, n)
            m = hi - lo
            lab = labels[lo:hi]
            # instance nuisance: global translate/scale, per-slot jitter,
            # mirror with p=0.5 (x -> -x maps exactly to a horizontal flip
            # because every shape type is mirror-symmetric)
            g = r.uniform(0.90, 1.12, size=(m, 1)).astype(np.float32)
            tx = r.uniform(-2.5, 2.5, size=(m, 1)).astype(np.float32) * scale
            ty = r.uniform(-2.5, 2.5, size=(m, 1)).astype(np.float32) * scale
            mirror = np.where(r.rand(m, 1) < 0.5, -1.0, 1.0).astype(np.float32)
            cx = (pcx[lab] * g * mirror + tx
                  + r.uniform(-1, 1, size=(m, K)).astype(np.float32) * scale)
            cy = (pcy[lab] * g + ty
                  + r.uniform(-1, 1, size=(m, K)).astype(np.float32) * scale)
            rad = prad[lab] * g * r.uniform(0.92, 1.08, size=(m, K)).astype(np.float32)
            # colors: bright NEAR-NEUTRAL shapes (lum 0.55-0.95, tint <=
            # +-0.08) on a dark near-neutral gradient background. Measured
            # failure mode of saturated random colors (diag runs A/B): the
            # reference's hue jitter is only 0.1, so a saturated instance
            # hue SURVIVES the train augmentations and hands the
            # negative-free family a zero-class-information invariant to
            # latch onto (BYOL collapsed to chance; SimCLR was immune —
            # 512 negatives make color alone insufficient to discriminate
            # instances). Near-neutral colors leave luminance as the only
            # color nuisance, and brightness jitter 0.4 scrambles that.
            # diag E narrowed the bands further: relative per-shape
            # luminance ordering survives multiplicative brightness jitter,
            # so a wide luminance band was itself a stable class-orthogonal
            # invariant. Appearance nuisance is now ~zero; the only cross-
            # view-stable structure left is the geometry, i.e. the class.
            lum = r.uniform(0.72, 0.88, size=(m, K, 1)).astype(np.float32)
            tint = r.uniform(-0.05, 0.05, size=(m, K, 3)).astype(np.float32)
            col = np.clip(lum + tint, 0.5, 1.0)
            bg_l = r.uniform(0.04, 0.16, size=(m, 1, 1, 1)).astype(np.float32)
            bg_t = r.uniform(-0.03, 0.03, size=(m, 1, 1, 3)).astype(np.float32)
            bg = np.clip(bg_l + bg_t, 0.0, 0.2)
            gx = r.uniform(-0.002, 0.002, size=(m, 1, 1, 1)).astype(np.float32)
            gy = r.uniform(-0.002, 0.002, size=(m, 1, 1, 1)).astype(np.float32)
            img = bg + gx * xx[None, :, :, None] + gy * yy[None, :, :, None]
            img = np.clip(img, 0.0, 0.22)
            for k in range(K):
                dx = xx[None] - cx[:, k, None, None]
                dy = yy[None] - cy[:, k, None, None]
                d = sdf(ptype[lab, k][:, None, None], dx, dy,
                        rad[:, k, None, None])
                mask = np.clip(0.5 - d / aa, 0.0, 1.0)[..., None]
                # class-characteristic interior texture, instance phase
                f = tfreq[lab, k][:, None, None]
                tt = ttype[lab, k][:, None, None]
                ph = r.uniform(0, 2 * np.pi, size=(m, 1, 1)).astype(np.float32)
                ph2 = r.uniform(0, 2 * np.pi, size=(m, 1, 1)).astype(np.float32)
                rr = np.sqrt(dx * dx + dy * dy)
                tex = np.where(tt == 0, np.sin(2 * np.pi * f * dy + ph), 0.0)
                tex = np.where(tt == 1, np.sin(2 * np.pi * f * dx + ph), tex)
                tex = np.where(tt == 2, np.sin(2 * np.pi * f * rr + ph), tex)
                tex = np.where(tt == 3, np.sin(2 * np.pi * f * dx + ph)
                               * np.sin(2 * np.pi * f * dy + ph2), tex)
                shade = (col[:, k, None, None, :]
                         * (1.0 + 0.45 * tex[..., None]))
                img = img * (1.0 - mask) + np.clip(shade, 0.0, 1.0) * mask
            img += r.normal(0, 0.03, size=img.shape).astype(np.float32)
            imgs[lo:hi] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        return SplitArrays(imgs, labels)

    return Dataset(name=name, train=split(n_train, 3), test=split(n_test, 4),
                   num_classes=num_classes, synthetic=True)


DATASETS = ("cifar10", "cifar100", "synth100", "shapes100")


def _write_cache(path: str, split: SplitArrays) -> None:
    """Writes a `.raw` cache under a name of this process's and renames it
    over `path`, so ranks loading at once never read one half written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        if native_io.write_raw_cache(tmp, split.images, split.labels):
            os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_dataset(dataset_name: str, root: str, allow_synthetic: bool = True,
                 synthetic_sizes: tuple[int, int] | None = None) -> Dataset:
    if dataset_name not in DATASETS:
        raise ValueError(f"Unknown dataset {dataset_name!r}")
    if dataset_name == "synth100":
        # always generated (never on disk): the non-saturating benchmark
        n_train, n_test = synthetic_sizes or (50000, 10000)
        return make_synthetic_hard("synth100", 100, n_train, n_test)
    if dataset_name == "shapes100":
        # always generated: the augmentation-invariant-structure benchmark
        n_train, n_test = synthetic_sizes or (50000, 10000)
        return make_synthetic_shapes("shapes100", 100, n_train, n_test)
    num_classes = 10 if dataset_name == "cifar10" else 100

    # fast-start flat cache (native writer; single sequential read)
    cache = os.path.join(root or ".", f"{dataset_name}_train.raw")
    cache_test = os.path.join(root or ".", f"{dataset_name}_test.raw")
    cached_train = native_io.read_raw_cache(cache)
    cached_test = native_io.read_raw_cache(cache_test)
    if cached_train is not None and cached_test is not None:
        return Dataset(dataset_name, SplitArrays(*cached_train),
                       SplitArrays(*cached_test), num_classes)

    loaded = None
    d = _find_binary_dir(root or ".", dataset_name)
    if d is not None:
        loaded = _load_cifar_binary_dir(d, dataset_name)
    else:
        d = _find_pickle_dir(root or ".", dataset_name)
        if d is not None:
            loaded = _load_cifar_pickle_dir(d)
    if loaded is not None:
        train, test, ncls = loaded
        try:
            os.makedirs(root or ".", exist_ok=True)
            _write_cache(cache, train)
            _write_cache(cache_test, test)
        except OSError:
            pass
        return Dataset(dataset_name, train, test, ncls)

    if not allow_synthetic:
        raise FileNotFoundError(
            f"{dataset_name} not found under {root!r} and downloads are disabled")
    n_train, n_test = synthetic_sizes or (50000, 10000)
    return make_synthetic(dataset_name, num_classes, n_train, n_test)
