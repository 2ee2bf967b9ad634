"""Stage CIFAR-10/100 for the port (the port of scripts/fetch_cifar.py).

    python -m ssv_tpu_torch.tools.fetch_cifar --dataset cifar10 --root data
        try the canonical URL and its mirror (30 s each); where there is no
        network, print the manual staging instructions and exit 2.

    python -m ssv_tpu_torch.tools.fetch_cifar --dataset cifar10 --root data \\
        --from /path/to/cifar-10-python.tar.gz   (or an extracted dir)
        stage from a local tarball or directory, with no network.

After staging, `ssv_tpu_torch.data.datasets.load_dataset` finds the data
under `--root` (or its parent: `data.root: data/cifar10` in the configs
finds `data/cifar-10-batches-py`). The tool loads it once with
`allow_synthetic=False`, which writes the flat `.raw` cache under `--root`
through the native IO library, so every later start is one sequential read.
The tarball is checked against the published md5 (a mismatch is a warning)
and extracted with tarfile's `data` filter. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys
import tarfile
import urllib.request

URLS = {
    "cifar10": [
        "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
        "https://ossci-datasets.s3.amazonaws.com/cifar-10-python.tar.gz",
    ],
    "cifar100": [
        "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
        "https://ossci-datasets.s3.amazonaws.com/cifar-100-python.tar.gz",
    ],
}
MD5 = {
    "cifar10": "c58f30108f718f92721af3b95e74349a",
    "cifar100": "eb9058c3a382ffc7106e4002c42a8d85",
}
EXTRACTED_DIR = {"cifar10": "cifar-10-batches-py", "cifar100": "cifar-100-python"}
BINARY_DIR = {"cifar10": "cifar-10-batches-bin", "cifar100": "cifar-100-binary"}
COMMAND = "python -m ssv_tpu_torch.tools.fetch_cifar"


def md5_of(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def stage_tarball(tar_path: str, dataset: str, root: str) -> str:
    """Extracts `tar_path` under `root`; returns the extracted directory."""
    got = md5_of(tar_path)
    if got != MD5[dataset]:
        print(f"WARNING: md5 mismatch for {tar_path}: got {got}, "
              f"expected {MD5[dataset]} — staging anyway, loader will "
              "fail loudly if the layout is wrong")
    os.makedirs(root, exist_ok=True)
    with tarfile.open(tar_path) as tf:
        tf.extractall(root, filter="data")
    out = os.path.join(root, EXTRACTED_DIR[dataset])
    if not os.path.isdir(out):
        raise FileNotFoundError(f"extraction did not produce {out}")
    return out


def try_download(dataset: str, root: str) -> str | None:
    """Downloads and stages the tarball from the first mirror that answers."""
    os.makedirs(root, exist_ok=True)
    tar_path = os.path.join(root, f"{dataset}-python.tar.gz")
    for url in URLS[dataset]:
        try:
            print(f"downloading {url} ...")
            with urllib.request.urlopen(url, timeout=30) as r, \
                    open(tar_path, "wb") as f:
                shutil.copyfileobj(r, f)
            return stage_tarball(tar_path, dataset, root)
        except OSError as e:
            print(f"  unreachable ({type(e).__name__}: {e})")
    return None


def warm_cache(dataset: str, root: str) -> None:
    """One real load: reads the pickles, writes the .raw cache."""
    from ..data.datasets import load_dataset

    ds = load_dataset(dataset, root, allow_synthetic=False)
    print(f"staged {dataset}: train {ds.train.images.shape}, "
          f"test {ds.test.images.shape}, classes {ds.num_classes}; "
          f".raw fast-start cache written under {root}/")


def instructions(dataset: str) -> str:
    """The manual staging instructions printed where no mirror answers."""
    tar = f"{EXTRACTED_DIR[dataset]}.tar.gz".replace("-batches-py", "-python")
    return f"""
No network route to any mirror. To stage manually, place ONE of these under
an accessible path and re-run with --from:

  * the official tarball  {tar}
    (md5 {MD5[dataset]}), or
  * an already-extracted  {EXTRACTED_DIR[dataset]}/  directory, or
  * the binary layout     {BINARY_DIR[dataset]}/
    (read natively by ssv_tpu_torch.data.native_io)

e.g.  {COMMAND} --dataset {dataset} --root data \\
          --from /mnt/transfer/{tar}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=COMMAND)
    ap.add_argument("--dataset", default="cifar10", choices=["cifar10", "cifar100"])
    ap.add_argument("--root", default="data",
                    help="staging directory (the `data.root` of the configs)")
    ap.add_argument("--from", dest="src", default=None,
                    help="local tarball or extracted directory to stage from")
    args = ap.parse_args(argv)

    if args.src:
        if os.path.isdir(args.src):
            dst = os.path.join(args.root, EXTRACTED_DIR[args.dataset])
            if os.path.abspath(args.src) != os.path.abspath(dst):
                os.makedirs(args.root, exist_ok=True)
                shutil.copytree(args.src, dst, dirs_exist_ok=True)
        else:
            stage_tarball(args.src, args.dataset, args.root)
        warm_cache(args.dataset, args.root)
        return 0

    if try_download(args.dataset, args.root):
        warm_cache(args.dataset, args.root)
        return 0

    print(instructions(args.dataset))
    return 2


if __name__ == "__main__":
    sys.exit(main())
