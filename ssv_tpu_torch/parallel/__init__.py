"""Data-parallel training across ranks (counterpart of ssv_tpu/parallel/).

`mesh` starts the process group and gives each rank its slice of a batch;
`per_device` holds the collectives of a step and the gradient reduction;
`sync_batchnorm` makes a built model's BatchNorms take their statistics
over the global batch; `dryrun` exercises all of it at a tiny size.
"""

from .mesh import batch_slice, rank, replicate, world_size
from .per_device import pgather, pmean, pmean_bn_, reduce_grads


def sync_batchnorm(module):
    """Switches every BatchNorm of the port in `module` to statistics over
    the global batch, in place (the state-dict keys stay as they were), and
    returns `module`."""
    from ..models.resnet import _FlaxRunningVar

    for m in module.modules():
        if isinstance(m, _FlaxRunningVar):
            m.sync = True
    return module


__all__ = ["batch_slice", "pgather", "pmean", "pmean_bn_", "rank", "reduce_grads",
           "replicate", "sync_batchnorm", "world_size"]
