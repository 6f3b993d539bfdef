"""The paper's accelerator configuration and the AlexNet-style CNN configs.

Port of ``repro.configs.alexnet_conv``.  :class:`PaperAccel` is the paper's
§4 layer (5×5 image, 15 channels, 3×3 kernel, 2 output channels, stride 1)
with B ∈ {4, 8, 16} bins; :class:`CNNConfig` stacks the same accelerator
into a full AlexNet-style conv stack with one dictionary per conv layer and a
dense classifier head.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

from repro_torch.core.conv import Conv2D

__all__ = ["PaperAccel", "PAPER_SPEC", "PAPER_BINS", "PAPER_BITWIDTHS",
           "CNNConfig", "config", "smoke_config", "SINGLE_POD"]

# the production single-pod mesh shape (data, model) the full config shards
# over (models/cnn.py::conv_mesh: one process a rank)
SINGLE_POD = (16, 16)


class PaperAccel(NamedTuple):
    """The paper's §4 accelerator dims (image geometry + layer shape)."""

    IH: int = 5
    IW: int = 5
    C: int = 15
    KY: int = 3
    KX: int = 3
    M: int = 2
    stride: int = 1

    def conv(self, *, relu: bool = False, bias: bool = False) -> Conv2D:
        """The geometry-free layer spec (paper kernel-centred windowing)."""
        return Conv2D(k=(self.KY, self.KX), c_in=self.C, c_out=self.M,
                      stride=self.stride, padding="valid_centred",
                      layout="NCHW", bias=bias, relu=relu)


PAPER_SPEC = PaperAccel()
PAPER_BINS = (4, 8, 16)
PAPER_BITWIDTHS = (8, 32)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """An AlexNet-family CNN on the weight-shared conv accelerator."""

    name: str
    in_chw: tuple  # (C, H, W) input images (C leads regardless of layout)
    layers: Sequence[Conv2D]  # per-stage specs (relu baked in; c_in chained)
    pools: Sequence[int]  # per-stage max-pool window == stride; 1 = none
    classes: int
    bins: int = 16  # dictionary size, one dictionary per conv layer
    groups: int = 1  # reduction-axis codebook groups per layer (1 = paper rule)
    impl: str = "kernel"  # auto | einsum | kernel | kernel_implicit
    padding: str = "valid_centred"  # stack-wide: valid_centred | valid | same
    layout: str = "NCHW"  # stack-wide: NCHW | NHWC
    packed: bool = False  # int4-pack the conv dictionaries at quantize time
    # kept for signature parity with the JAX package: sized its TPU VMEM
    # schedule; unused by the port
    vmem_budget: Optional[int] = None
    pool_impl: str = "auto"  # conv2d(pool_impl=) policy for the stage pools
    # (n_data, n_model) for launch.mesh.make_conv_mesh (cnn.conv_mesh): the
    # mesh the stack shards over (conv2d(mesh=)); None = every rank on data
    mesh_shape: Optional[tuple] = None
    family: str = "cnn"

    def __post_init__(self):
        if len(self.layers) != len(self.pools):
            raise ValueError(
                f"{self.name}: {len(self.layers)} conv layers but "
                f"{len(self.pools)} pool entries — the sequences are parallel"
            )
        c_in = self.in_chw[0]
        for i, conv in enumerate(self.layers):
            if conv.c_in != c_in:
                raise ValueError(
                    f"{self.name}: layer {i} expects c_in={conv.c_in} but the "
                    f"stack feeds it {c_in} channels"
                )
            c_in = conv.c_out


def _stack(c_in: int, *stages: tuple) -> tuple:
    """(c_out, k, stride) stages → chained Conv2D specs with ReLU."""
    layers = []
    for c_out, k, stride in stages:
        layers.append(Conv2D(k=k, c_in=c_in, c_out=c_out, stride=stride, relu=True))
        c_in = c_out
    return tuple(layers)


def config() -> CNNConfig:
    """Full AlexNet-style stack at the paper's ImageNet-scale layer sizes."""
    return CNNConfig(
        name="alexnet",
        in_chw=(3, 224, 224),
        layers=_stack(
            3,
            (96, 11, 4),  # 224→54→27 (valid_centred; SAME: 224→56→28)
            (256, 5, 1),  # 27→23→11
            (384, 3, 1),  # 11→9
            (384, 3, 1),  # 9→7
            (256, 3, 1),  # 7→5→2
        ),
        pools=(2, 2, 1, 1, 2),
        classes=1000,
        mesh_shape=SINGLE_POD,
    )


def smoke_config() -> CNNConfig:
    """CIFAR-sized stack: same code path, CPU-testable."""
    return CNNConfig(
        name="alexnet-smoke",
        in_chw=(3, 32, 32),
        layers=_stack(
            3,
            (16, 3, 1),  # 32→30→15
            (32, 3, 1),  # 15→13→6
            (32, 3, 1),  # 6→4→2
        ),
        pools=(2, 2, 2),
        classes=10,
    )
