"""Multi-crop views for DINO (port of ssv_tpu/data/multicrop.py).

The base train transform runs twice over the batch (aug_1, aug_2), each
time through `build_batch_transform`, so its leading photometric pair is
one launch of the fused kernel per run. Each augmented image is then
cropped `num_global` times at `global_size` with scale (s, 1.0) and
`num_local` times at `local_size` with scale (0.08, s), resampled bicubic.

A group's V crops of the B images are one `random_resized_crop` over the
B*V images repeated in place (image-major), so every crop draws its own
box, as under the JAX package's vmap, and a group costs the launches of
one call, not V.
"""

from __future__ import annotations

from .augment import build_batch_transform, random_resized_crop


class MultiCrop:
    def __init__(self, config: dict):
        cfg = dict(config)
        self.num_local = int(cfg.get("num_local_views", 6))
        self.num_global = int(cfg.get("num_global_views", 2))
        s = float(cfg.get("scale_threshold", 0.3))
        self.global_size = tuple(cfg["global_size"])
        self.local_size = tuple(cfg["local_size"])
        self.global_scale = (s, 1.0)
        self.local_scale = (0.08, s)
        self.base_batch_transform = build_batch_transform(cfg["train_transforms"])

    @staticmethod
    def crops(generator, images, n: int, size, scale):
        """(B, H, W, 3) -> (B, n, *size, 3): n bicubic random resized crops
        of each image, one box each."""
        B = images.shape[0]
        out = random_resized_crop(generator, images.repeat_interleave(n, dim=0), size,
                                  scale=scale, method="cubic")
        return out.reshape(B, n, *out.shape[1:])

    def batch_call(self, generator, images):
        """uint8 or float (B, H, W, 3) images -> {global_1, global_2:
        (B, Vg, *global_size, 3), local_1, local_2: (B, Vl, *local_size, 3)}."""
        aug_1 = self.base_batch_transform(generator, images)
        aug_2 = self.base_batch_transform(generator, images)
        glob = (self.num_global, self.global_size, self.global_scale)
        loc = (self.num_local, self.local_size, self.local_scale)
        return {
            "global_1": self.crops(generator, aug_1, *glob),
            "global_2": self.crops(generator, aug_2, *glob),
            "local_1": self.crops(generator, aug_1, *loc),
            "local_2": self.crops(generator, aug_2, *loc),
        }
