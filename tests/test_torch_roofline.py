"""The port's byte and FLOP counters and its roofline, on the CPU.

* ``core/hwmodel.py``'s traffic terms: ``dense_weight_stream_bytes``,
  ``dense_hbm_traffic`` and the explicit-im2col ``conv_hbm_traffic`` are
  ``==`` the JAX package's over a grid; the implicit term is ``==`` JAX's
  where the image is unpadded and fits JAX's VMEM slab budget, and
  elsewhere reads the unpadded image once (K2/K4 mask the padding).
* ``kernels/ops.py``: ``matmul_flops`` ``==`` JAX's; ``pasm_hbm_bytes`` and
  ``conv_hbm_bytes`` follow their identities on the port's plans, with and
  without split-K partials, and per device under ``shards=``.
* ``roofline.py``: the terms' arithmetic and the bottleneck, the ring
  weights, ``bound_ms``, and ``StepCounter``'s exact FLOPs and bytes on a
  known matmul and conv, real and ``meta`` (its FLOPs are
  ``FlopCounterMode``'s).
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.core import hwmodel as jhw
from repro.kernels import ops as jops
from repro_torch import roofline as RL
from repro_torch.core import conv as cv
from repro_torch.core import hwmodel as thw
from repro_torch.core import pasm
from repro_torch.kernels import ops, pas_histogram as ph, pasm_matmul as pm

# (IH, IW, C, KY, KX, M, stride, pad, pool): the paper's accelerator, AlexNet
# conv1 / conv2 / conv3, a SAME conv, and a 600x600 image past JAX's budget
CONVS = [
    (5, 5, 15, 3, 3, 2, 1, (0, 0, 0, 0), 1),
    (224, 224, 3, 11, 11, 96, 4, (0, 0, 0, 0), 2),
    (27, 27, 96, 5, 5, 256, 1, (2, 2, 2, 2), 2),
    (13, 13, 256, 3, 3, 384, 1, (1, 1, 1, 1), 1),
    (56, 56, 64, 3, 3, 64, 2, (0, 1, 0, 1), 1),
    (600, 600, 3, 11, 11, 96, 4, (0, 0, 0, 0), 1),
]


@pytest.mark.parametrize("geom", CONVS, ids=lambda g: f"{g[0]}x{g[1]}x{g[2]}k{g[3]}")
@pytest.mark.parametrize("bins,packed", [(4, True), (16, True), (16, False), (256, False)])
def test_conv_hbm_traffic_matches_jax(geom, bins, packed):
    IH, IW, C, KY, KX, M, stride, pad, pool = geom
    for batch in (1, 8):
        for act_bytes in (2, 4):
            for dense in (False, True):
                kw = dict(IH=IH, IW=IW, C=C, KY=KY, KX=KX, M=M, stride=stride,
                          batch=batch, bins=bins, pad=pad, act_bytes=act_bytes,
                          packed=packed, pool=pool, dense=dense)
                assert thw.conv_hbm_traffic(**kw, implicit=False) == \
                    jhw.conv_hbm_traffic(**kw, implicit=False)
                got = thw.conv_hbm_traffic(**kw, implicit=True)
                hp, wp = IH + pad[0] + pad[1], IW + pad[2] + pad[3]
                if sum(pad) == 0 and 2 * C * hp * wp * act_bytes <= 6 << 20:
                    assert got == jhw.conv_hbm_traffic(**kw, implicit=True)
                # the unpadded image read once, the rest as the explicit term's
                rest = thw.conv_hbm_traffic(**kw, implicit=False) - 2 * batch * (
                    ((hp - KY) // stride + 1) // pool * (((wp - KX) // stride + 1) // pool)
                    * pool * pool) * C * KY * KX * act_bytes
                assert got == batch * C * IH * IW * act_bytes + rest


@pytest.mark.parametrize("K,N", [(512, 256), (2400, 256), (5120, 25600), (1408, 2048)])
def test_dense_traffic_terms_match_jax(K, N):
    for bins, groups, packed, dense in [(16, 1, True, False), (16, 4, True, False),
                                        (256, 1, False, False), (16, 1, True, True)]:
        kw = dict(bins=bins, groups=groups, packed=packed, dense=dense)
        assert thw.dense_weight_stream_bytes(K, N, **kw) == \
            jhw.dense_weight_stream_bytes(K, N, **kw)
        for db in (1, 2, 4):
            assert thw.dense_weight_stream_bytes(K, N, **kw, dense_dtype_bytes=db) == \
                jhw.dense_weight_stream_bytes(K, N, **kw, dense_dtype_bytes=db)
        for T in (1, 4, 384):
            for act in (2, 4):
                assert thw.dense_hbm_traffic(T=T, K=K, N=N, act_bytes=act, **kw) == \
                    jhw.dense_hbm_traffic(T=T, K=K, N=N, act_bytes=act, **kw)
        assert ops.matmul_flops(7, K, N) == jops.matmul_flops(7, K, N) == 2 * 7 * K * N


def _t(K, N, bins=16, pack=True, groups=1):
    """A weight-shared (K, N) operand (the counters read its shapes only)."""
    rows = K // 2 if pack else K
    return pasm.PASMTensor(idx=torch.zeros((rows, N), dtype=torch.uint8),
                           codebook=torch.zeros((groups, bins)), shape=(K, N), bins=bins,
                           bits=pasm.bits_for_bins(bins), packed=pack)


@pytest.mark.parametrize("K,N,bins,pack,M,act", [
    (512, 256, 16, True, 8, 2),  # no split: stream at 8 rows
    (512, 256, 64, False, 8, 4),  # f32 x: simt, no split
    (5120, 5120, 16, True, 4, 2),  # stream, split-K
    (5120, 5120, 16, True, 384, 2),  # mma, split-K
    (3456, 384, 16, False, 64, 4),  # simt split-K (AlexNet conv4's shape)
])
def test_pasm_hbm_bytes_identity(K, N, bins, pack, M, act):
    t = _t(K, N, bins, pack)
    got = ops.pasm_hbm_bytes(t, M, act)
    base = M * K * act + t.nbytes_weights + M * N * 4
    plan = pm.k1_plan(M, K, N, torch.bfloat16 if act == 2 else torch.float32,
                      packed=t.packed, groups=t.groups)
    assert got == base + 2 * plan.scratch * 4
    assert (plan.splits > 1) == (got > base)
    if (K, N, M, act) == (512, 256, 8, 2):  # JAX's pinned aligned identity
        assert got == 8 * 512 * 2 + t.nbytes_weights + 8 * 256 * 4


@pytest.mark.parametrize("stage", [0, 2, 4])
@pytest.mark.parametrize("use_pas", [False, True])
def test_conv_hbm_bytes_identity(stage, use_pas):
    """AlexNet conv1 (no split), conv3 and conv5 (split-K) on K1/K2 or K3/K4,
    one device and sharded: the unpadded image or the im2col store and
    read, the kernel's indices, the dictionaries, the pooled output and the
    split-K partials of the port's plan."""
    (ih, iw, c, k, m, stride, pad, pool) = [
        (224, 224, 3, 11, 96, 4, "valid", 2), (27, 27, 96, 5, 256, 1, "same", 2),
        (13, 13, 256, 3, 384, 1, "same", 1), (13, 13, 384, 3, 384, 1, "same", 1),
        (13, 13, 384, 3, 256, 1, "same", 2)][stage]
    conv = cv.Conv2D(k=k, c_in=c, c_out=m, stride=stride, padding=pad)
    g = torch.Generator().manual_seed(stage)
    params = cv.ConvParams.quantize(torch.randn((m, c, k, k), generator=g), 16, iters=1)
    for p in (params, params.pack()):
        t = p.gemm_tensor()
        Kp = t.idx.shape[0] * (2 if t.packed else 1)
        geom = cv.conv_geom(conv, ih, iw, pool=pool)
        for batch, shards in ((32, (1, 1)), (32, (4, 2)), (6, (4, 1)), (8, (1, 5))):
            nd, nm = shards
            b = -(-batch // nd)
            n = m // nm if m % nm == 0 else m
            M = b * geom.P_rows
            whole = (batch * geom.P_rows, m)
            if use_pas:
                plan = ph.pas_plan(M, Kp, n, t.codebook.shape[-1], pool, whole=whole)
                idx = Kp * n
            else:
                idx = t.idx.shape[0] * n
            for implicit, act in ((True, 4), (False, 4), (False, 2)):
                if not use_pas:
                    plan = pm.simt_plan(M, Kp, n, pool, whole=whole) if implicit else \
                        pm.k1_plan(M, Kp, n, torch.bfloat16 if act == 2 else torch.float32,
                                   pool, packed=t.packed, groups=t.groups, whole=whole)
                x = b * c * ih * iw * act if implicit else 2 * M * Kp * act
                want = x + idx + t.codebook.numel() * 4 + b * geom.P_out * n * 4 \
                    + 2 * plan.scratch * 4
                assert ops.conv_hbm_bytes(t, geom, batch, ih, iw, implicit=implicit,
                                          act_bytes=act, shards=shards,
                                          use_pas=use_pas) == want
                if stage == 4 or (stage and not use_pas and (implicit or act == 4)):
                    assert plan.splits > 1  # K1/K2 split conv3 and conv5, K3/K4 conv5


def test_roofline_terms_and_bottleneck():
    hw = RL.HW()
    coll = RL.collective_stats({("all-reduce", 16): [1e12, 3]})
    r = RL.roofline_terms(arch="a", shape="s", mesh_name="16x16", n_devices=256,
                          flops=hw.bf16_flops, nbytes=hw.hbm_bw / 2, collectives=coll,
                          model_flops=hw.bf16_flops * 256 * 0.5)
    assert np.isclose(r.compute_s, 1.0) and np.isclose(r.memory_s, 0.5)
    assert np.isclose(r.collective_s, 1e12 * 2 * 15 / 16 / hw.link_bw)
    assert r.bottleneck == "collective" and r.step_time_s == r.collective_s
    assert np.isclose(r.roofline_fraction, 0.5 / r.collective_s)
    assert np.isclose(r.useful_flops_frac, 0.5)
    r2 = RL.roofline_terms(arch="a", shape="s", mesh_name="1x1", n_devices=1, flops=2e9,
                           nbytes=1e9, collectives=RL.collective_stats({}), model_flops=1e12,
                           extra={"argument_bytes_per_device": 5e8})
    assert r2.bottleneck == "memory" and np.isclose(r2.memory_efficiency, 0.5)
    assert "hw" in r2.to_json() and r2.collective_bytes == 0


def test_collective_ring_weights_and_bound():
    st = RL.collective_stats({("all-reduce", 16): [1600, 2], ("all-gather", 4): [400, 1],
                              ("all-gather", 16): [160, 3], ("all-reduce", 1): [99, 1]})
    assert np.isclose(st.bytes_by_kind["all-reduce"], 1600 * 2 * 15 / 16)
    assert np.isclose(st.bytes_by_kind["all-gather"], 400 * 3 / 4 + 160 * 15 / 16)
    assert st.count_by_kind == {"all-reduce": 3, "all-gather": 4}
    b = RL.bound_ms(989e12, 3.35e12 / 2, torch.bfloat16)
    assert np.isclose(b.ms, 1e3) and b.by == "operations" and np.isclose(b.bytes_ms, 500)
    b = RL.bound_ms(67e9, 3.35e12, torch.float32)
    assert np.isclose(b.ms, 1e3) and b.by == "bytes" and np.isclose(b.ops_ms, 1.0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_step_counter_exact_on_matmul_and_conv(device):
    a = torch.randn((64, 32), device=device)
    w = torch.randn((32, 16), device=device)
    x = torch.randn((2, 3, 9, 9), device=device)
    k = torch.randn((4, 3, 3, 3), device=device)
    with RL.StepCounter() as c, FlopCounterMode(display=False) as f:
        y = a @ w
        y2 = y.reshape(16, 64).t()  # views move nothing
        z = torch.relu(y)
        del y2
        o = torch.nn.functional.conv2d(x, k)
        z.add_(1.0)  # elementwise in place: read and written
    assert c.flops == f.get_total_flops() == 2 * 64 * 32 * 16 + 2 * 2 * 4 * 7 * 7 * 27
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    relu, conv = 2 * 64 * 16 * 4, (x.numel() + k.numel() + o.numel()) * 4
    assert dict(c.op_bytes_by_kind()) == {"mm": mm, "relu": relu, "convolution": conv,
                                          "add_": 2 * 64 * 16 * 4}
    assert c.nbytes == mm + relu + conv + 2 * 64 * 16 * 4
    assert c.peak_bytes == 2 * 64 * 16 * 4 + o.numel() * 4  # y and z, then o
    assert c.biggest_tensors(1)[0][0] == 64 * 16 * 4
