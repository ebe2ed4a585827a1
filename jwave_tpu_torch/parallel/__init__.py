"""The sharded layer: a device mesh over ``torch.distributed`` and SPMD
transforms on it, one process per device.

The JAX package's names and contracts (``jwave_tpu.parallel``):

  * scale-sharded CWT and synchrosqueezing, and batch sharding for
    many-signal workloads, with no communication (SSQ: one psum);
  * 2D/3D separable FWT/WPT with an all_to_all distributed transpose;
  * time-sharded MODWT and FWT with ring-shift halo exchange of filter-
    support samples;
  * a distributed four-step FFT (pfft) under the time-sharded MODWT of any
    depth and the time-sharded CWT, whose working set stays N/D per rank.

Results are ``torch.distributed.tensor.DTensor``s laid out as the JAX
functions' outputs. On the CPU a gloo world (``torchrun --nproc-per-node
4`` or ``torch.multiprocessing``) with ``make_mesh(device_type="cpu")``
runs it; on the card, NCCL with one rank per card.
"""
from .mesh import initialize_distributed, make_mesh
from .pfft import pfft, pfft2, pifft, pifft2
from .sharded import (
    batch_sharded,
    cwt_batch_scale_sharded,
    cwt_scale_sharded,
    cwt_time_sharded,
    fwt2d_sharded,
    fwt2d_tile_sharded,
    fwt3d_sharded,
    fwt_halo_sharded,
    gather_pyramid,
    gather_pyramid_2d,
    ifwt2d_sharded,
    ifwt3d_sharded,
    imodwt2d_sharded,
    imodwt_fft_sharded,
    imodwt_halo_sharded,
    iwpt2d_sharded,
    iwpt3d_sharded,
    modwt2d_sharded,
    modwt_fft_sharded,
    modwt_halo_sharded,
    ssq_scale_sharded,
    wpt2d_sharded,
    wpt3d_sharded,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "batch_sharded",
    "cwt_scale_sharded",
    "ssq_scale_sharded",
    "cwt_batch_scale_sharded",
    "cwt_time_sharded",
    "fwt2d_sharded",
    "ifwt2d_sharded",
    "wpt2d_sharded",
    "iwpt2d_sharded",
    "fwt3d_sharded",
    "ifwt3d_sharded",
    "wpt3d_sharded",
    "iwpt3d_sharded",
    "modwt_halo_sharded",
    "fwt_halo_sharded",
    "fwt2d_tile_sharded",
    "gather_pyramid",
    "gather_pyramid_2d",
    "imodwt_halo_sharded",
    "modwt_fft_sharded",
    "imodwt_fft_sharded",
    "pfft",
    "pifft",
    "pfft2",
    "pifft2",
    "modwt2d_sharded",
    "imodwt2d_sharded",
]
