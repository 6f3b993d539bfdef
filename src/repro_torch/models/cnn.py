"""AlexNet-style CNN on the weight-shared conv accelerator.

Port of ``repro.models.cnn``, inference and QAT.
Conv/ReLU/pool stages, each conv carrying its own dictionary (the paper's
one-dictionary-per-layer rule), then a dense classifier head.  Every stage is
one :class:`~repro_torch.core.conv.ConvParams` +
:class:`~repro_torch.core.conv.Conv2D` pair through
:func:`repro_torch.core.conv.conv2d`; on the kernel engines bias, ReLU and
the stage's max-pool fuse into one launch.  Params are a plain dict, as in
the JAX package::

    cfg = alexnet_conv.smoke_config()
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    qparams = cnn.quantize(params, cfg)          # per-layer k-means codebooks
    logits = cnn.forward(qparams, images, cfg)   # (B, classes) via K1 / K2

Sharded, SPMD: every rank runs the same code with the same global images
(``torch.distributed`` started by the caller)::

    mesh = make_conv_mesh((n_data, n_model))         # ("data", "model")
    qparams = cnn.quantize(params, cfg, mesh=mesh)   # this rank's c_out blocks
    logits = cnn.forward(qparams, images, cfg, mesh=mesh)  # global, every rank

QAT (:mod:`repro_torch.core.qat`'s STE through the conv dictionaries)::

    cbs = cnn.qat_codebooks(params, cfg)               # per-layer dictionaries
    logits = cnn.qat_forward(params, cbs, images, cfg)  # STE-snapped forward
    qparams = cnn.qat_requantize(params, cbs, cfg)      # freeze for serving

Sharded QAT places the dense masters (``c_out`` over ``model``) after the
dictionaries are drawn from the global masters, the same on every rank::

    tree = {"params": params, "codebooks": cnn.qat_codebooks(params, cfg)}
    tree = cnn._place(tree, mesh)                     # blocks; codebooks whole
    step = train.step.make_cnn_train_step(cfg, ocfg, mesh=mesh)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.alexnet_conv import CNNConfig
from repro_torch.core import conv as _conv
from repro_torch.core import pasm as _pasm
from repro_torch.core import qat as _qat
from repro_torch.core._f32 import matmul_f32
from repro_torch.models.common import Initializer

__all__ = ["stages", "feature_shape", "init_params", "quantize", "forward",
           "forward_dense", "conv_mesh", "qat_codebooks", "qat_apply",
           "qat_forward", "qat_requantize"]

# CNNConfig.impl == conv2d engine (pas_kernel_implicit is reached through
# conv2d only, as in the JAX package)
_IMPLS = ("auto", "einsum", "kernel", "kernel_implicit", "pas_kernel")


def stages(cfg: CNNConfig) -> list:
    """Per-stage ``(Conv2D, pool)`` with the stack-wide padding/layout applied."""
    return [
        (dataclasses.replace(c, padding=cfg.padding, layout=cfg.layout), p)
        for c, p in zip(cfg.layers, cfg.pools)
    ]


def feature_shape(cfg: CNNConfig) -> tuple:
    """(C, H, W) entering the classifier head."""
    C, H, W = cfg.in_chw
    for conv, pool in stages(cfg):
        H, W = _conv.conv_out_hw(H, W, conv)
        if pool > 1:
            H, W = H // pool, W // pool
        C = conv.c_out
    return C, H, W


def init_params(cfg: CNNConfig, gen: torch.Generator, *, device=None) -> dict:
    """Dense master weights drawn from ``gen`` (on its own device), placed on
    ``device`` (default the card): per-layer ConvParams + head matrix.
    ``device="meta"``: the shapes only, no generator needed."""
    dev = resolve_device(device)
    ini = Initializer(gen, device)
    convs = []
    for conv, _pool in stages(cfg):
        fan_in = conv.c_in * conv.ky * conv.kx
        kernel = ini.dense((conv.c_out, conv.c_in, conv.ky, conv.kx), fan_in=fan_in)
        convs.append(_conv.ConvParams.dense(
            kernel.to(dev), bias=torch.zeros(conv.c_out, device=dev)))
    C, H, W = feature_shape(cfg)
    return {
        "conv": convs,
        "head": {"w": ini.dense((C * H * W, cfg.classes)).to(dev),
                 "b": torch.zeros(cfg.classes, device=dev)},
    }


def conv_mesh(cfg: CNNConfig, *, device=None):
    """``cfg.mesh_shape`` → the stack's ``("data", "model")`` mesh (every
    rank of the process group; ``None`` puts them all on ``data``)."""
    from repro_torch.launch.mesh import make_conv_mesh

    return make_conv_mesh(cfg.mesh_shape, device=device)


def _place(params: dict, mesh) -> dict:
    """This rank's block of every leaf per the ``models/sharding.py`` CNN
    rules (``c_out`` over ``model``, codebooks replicated), copied out on
    ``mesh.device`` so a rank's weight memory shrinks with the mesh.  A
    container keeps its global metadata (``kshape``), as a JAX array placed
    on a mesh keeps its global shape."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models import sharding as _sharding

    specs = _sharding.conv_param_pspecs(params, axis_sizes(mesh))
    return _sharding.place_tree(params, specs, mesh, wrap=False)


def quantize(params: dict, cfg: CNNConfig, *, iters: int = 16, mesh=None) -> dict:
    """K-means weight-share every conv layer (on the weights' device): one
    dictionary per layer, ``cfg.groups`` reduction-axis dictionaries when
    > 1, int4-packed into the stack layout's GEMM order when ``cfg.packed``.
    ``mesh=`` then keeps this rank's blocks (:func:`_place`): each rank
    holds ``1/n_model`` of every idx, bias and the head, and every
    codebook."""
    convs = []
    for p in params["conv"]:
        q = _conv.ConvParams.quantize(p.kernel, cfg.bins, bias=p.bias,
                                      iters=iters, groups=cfg.groups,
                                      layout=cfg.layout)
        if cfg.packed:
            q = q.pack(layout=cfg.layout)
        convs.append(q)
    out = {"conv": convs, "head": params["head"]}
    return _place(out, mesh) if mesh is not None else out


def _head(x: torch.Tensor, head: dict, mesh=None, *,
          n_cols: Optional[int] = None) -> torch.Tensor:
    """Dense classifier (full f32 product).  Under ``mesh=``, ``x`` is this
    rank's ``data`` rows and the ``n_cols`` classes split over ``model``
    when they divide it (the head global or this rank's block), gathered
    back: this rank's rows of the logits.  The contraction keeps the whole
    feature axis on every rank, as the JAX head's ``shard_map`` does."""
    xf = x.reshape(x.shape[0], -1)
    if mesh is None:
        return matmul_f32(xf, head["w"]) + head["b"]
    from repro_torch.kernels.ops import shard_gemm

    return shard_gemm(mesh, n_cols,
                      lambda xl, wl, _cb, bl, _whole: matmul_f32(xl, wl) + bl,
                      xf, head["w"], None, head["b"], local_rows=True)


def _stack(params: dict, images: torch.Tensor, cfg: CNNConfig, engine: str,
           pool_impl: str, mesh) -> torch.Tensor:
    if mesh is None:
        x = images
        for p, (conv, pool) in zip(params["conv"], stages(cfg)):
            x = _conv.conv2d(x, p, conv, engine=engine, pool=pool,
                             pool_impl=pool_impl)
        return _head(x, params["head"])
    x = _conv.shard_batch(images, mesh)
    for p, (conv, pool) in zip(params["conv"], stages(cfg)):
        x = _conv.conv2d_shard(x, p, conv, mesh=mesh, engine=engine, pool=pool,
                               pool_impl=pool_impl)
    y = _head(x, params["head"], mesh, n_cols=cfg.classes)
    return _conv.gather_batch(y, mesh, images.shape[0])


def forward(params: dict, images: torch.Tensor, cfg: CNNConfig, *,
            mesh=None) -> torch.Tensor:
    """Quantized forward: images (in ``cfg.layout`` order) → logits.

    ``cfg.impl`` picks the conv engine: ``kernel`` runs K1 over an explicit
    im2col patch matrix, ``kernel_implicit`` K2 on the raw image,
    ``pas_kernel`` the paper-faithful two-phase K3 over the patches (one
    dictionary per layer), ``einsum`` the plain reference, ``auto`` K2 for
    batches.  Each stage's pool rides
    ``conv2d(pool=)`` (fused into the kernel epilogue where possible).

    ``mesh=`` runs the stack sharded: every rank passes the same global
    images and gets the global logits.  The batch splits over ``data``
    once (an uneven remainder padded), each stage runs
    :func:`~repro_torch.core.conv.conv2d_shard` on the rank's images with
    its ``model`` block of the output channels and gathers the channels,
    and the batch is gathered once, after the head — bitwise the
    single-device forward on every conv stage.
    """
    if cfg.impl not in _IMPLS:
        raise ValueError(f"impl must be one of {'|'.join(_IMPLS)}, got {cfg.impl!r}")
    return _stack(params, images, cfg, cfg.impl, cfg.pool_impl, mesh)


def forward_dense(params: dict, images: torch.Tensor, cfg: CNNConfig, *,
                  mesh=None) -> torch.Tensor:
    """Reference forward on the dense master weights (no weight sharing);
    ``mesh=`` as in :func:`forward`, on the sharded plain engine."""
    return _stack(params, images, cfg, "einsum", "auto", mesh)


# ---------------------------------------------------------------------------
# QAT: core/qat.py's STE through the conv stack's per-layer dictionaries
# ---------------------------------------------------------------------------


def _qat_check_groups(cfg: CNNConfig) -> None:
    if cfg.groups > 1:
        raise ValueError(
            "CNN QAT is single-dictionary (the paper's per-layer rule): "
            f"cfg.groups={cfg.groups} would train/freeze a different "
            "quantization scheme than quantize() serves; set groups=1"
        )


def qat_codebooks(params: dict, cfg: CNNConfig, *, iters: int = 16) -> list:
    """Initial per-layer dictionaries: k-means over each dense master kernel
    (the rule :func:`quantize` bakes into ``shared`` params), kept as plain
    ``(bins,)`` tensors so they can be trained.  Under a mesh every rank
    draws them from the global masters, before :func:`_place`: a rank's
    block would give another dictionary."""
    _qat_check_groups(cfg)
    for p in params["conv"]:
        if tuple(p.kernel.shape) != tuple(p.kshape):
            raise ValueError(
                f"qat_codebooks needs the global masters, got a placed block "
                f"{tuple(p.kernel.shape)} of {p.kshape}: draw the dictionaries "
                "before placing the tree")
    return [_pasm.kmeans_codebook(p.kernel.reshape(-1, 1), cfg.bins, groups=1,
                                  iters=iters)[0][0]
            for p in params["conv"]]


def qat_apply(params: dict, codebooks) -> dict:
    """STE-snap every dense master ``ConvParams`` onto its layer dictionary:
    the forward serves codebook values, the gradient flows straight through
    to the master and each codebook entry gathers the bin-summed gradients
    of its weights.  Bias stays dense (§4).  Placed masters (a rank's
    ``c_out`` block, :func:`_place`) snap onto the whole dictionaries and
    keep their global ``kshape``: a codebook entry's gradient is then this
    rank's block's bin sums, which the sharded step sums over ``model``."""
    convs = [dataclasses.replace(
        _conv.ConvParams.dense(_qat.ste_quantize(p.kernel, cb), bias=p.bias),
        kshape=p.kshape) for p, cb in zip(params["conv"], codebooks)]
    return {"conv": convs, "head": params["head"]}


def qat_forward(params: dict, codebooks, images: torch.Tensor, cfg: CNNConfig,
                *, mesh=None) -> torch.Tensor:
    """QAT training forward: masters STE-snapped, then the dense reference
    engine (differentiable in masters, codebooks, bias and head).  ``mesh=``
    runs it sharded on placed masters (:func:`_place`) with whole
    codebooks: :func:`forward_dense` under the mesh, the ``einsum`` engine
    through the same dispatch as JAX's ``shard_map``, every rank passing
    the global images and getting the global logits."""
    return forward_dense(qat_apply(params, codebooks), images, cfg, mesh=mesh)


def _like(cfg: CNNConfig) -> dict:
    """The global QAT tree's shapes as meta tensors (no data)."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    convs = [_conv.ConvParams.dense(meta(c.c_out, c.c_in, c.ky, c.kx), bias=meta(c.c_out))
             for c, _ in stages(cfg)]
    C, H, W = feature_shape(cfg)
    return {"params": {"conv": convs, "head": {"w": meta(C * H * W, cfg.classes),
                                               "b": meta(cfg.classes)}},
            "codebooks": [meta(cfg.bins) for _ in convs]}


def qat_specs(cfg: CNNConfig, mesh, *, with_opt: bool = False):
    """The spec tree ``cnn._place`` places a QAT tree (``{"params":
    masters, "codebooks": [...]}``) by on ``mesh``, or with ``with_opt``
    the ``(tree, optimizer state)`` pair a checkpoint holds: from the
    config's global shapes, so a rank holding blocks can gather them
    (``models/sharding.py::gather_params``)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models import sharding as _sharding
    from repro_torch.train.optimizer import init_opt_state

    like = _like(cfg)
    if with_opt:
        like = (like, init_opt_state(like))
    return _sharding.conv_param_pspecs(like, axis_sizes(mesh))


def qat_reads(cfg: CNNConfig) -> dict:
    """The QAT tree's whole leaves read by rank blocks: layer ``i``'s
    dictionary by its master's ``c_out`` block
    (``models/sharding.py::grad_reduce_axes``'s ``reads``)."""
    return {f"codebooks/{i}": f"params/conv/{i}" for i in range(len(cfg.layers))}


def qat_requantize(params: dict, codebooks, cfg: CNNConfig, *, mesh=None) -> dict:
    """Freeze trained masters onto their dictionaries for serving.

    The re-assignment is :func:`repro_torch.core.qat.assign_bins`, the STE
    forward's own rule, so the frozen ``shared`` params' :func:`forward`
    equals :func:`qat_forward` at the same masters and codebooks.  ``mesh=``
    keeps this rank's blocks, as in :func:`quantize`.
    """
    _qat_check_groups(cfg)
    convs = []
    for p, cb in zip(params["conv"], codebooks):
        idx = _qat.assign_bins(p.kernel, cb).to(torch.uint8)
        q = _conv.ConvParams.shared(idx, cb, bias=p.bias)
        if cfg.packed:
            q = q.pack(layout=cfg.layout)
        convs.append(q)
    out = {"conv": convs, "head": params["head"]}
    return _place(out, mesh) if mesh is not None else out
