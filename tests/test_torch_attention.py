"""The port's attention and K5's plain version against the JAX package.

Same numpy inputs through ``repro.nn.attention`` / ``repro.kernels.ops``
(the Pallas flash-attention kernel in interpret mode) and their
``repro_torch`` counterparts, at ``tests/test_attention.py``'s and
``tests/test_kernels.py``'s shapes.  Tolerances: f32 paths agree to 2e-5
(sums in another order); bf16 outputs to one bf16 ulp of the output scale
(the two frameworks round the same f32 value, computed in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_kernel_call as j_k5
from repro.nn import attention as JA
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pasm_matmul as tpm
from repro_torch.nn import attention as TA

F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(B=2, S=64, H=4, KV=2, hd=16, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _both(*arrays, dtype="float32"):
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "dtype") and not \
        isinstance(x, torch.Tensor) else x.float().numpy()


def _bf16_close(got, want):
    """One bf16 ulp at the output's scale (2**-7 of max |want|)."""
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_matches_jax(chunk, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv())
    want = JA.gqa_attention(jq, jk, jv, causal=causal, chunk=chunk)
    got = TA.gqa_attention(tq, tk, tv, causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window,S,chunk,q_offset", [
    (8, 48, 16, 0), (16, 48, 16, 0), (None, 56, 16, 0), (None, 40, 64, 0),
    (12, 24, 8, 16),
])
def test_gqa_attention_window_pad_offset(window, S, chunk, q_offset):
    q, k, v = _qkv(S=S)
    if q_offset:
        k, v = np.concatenate([k, k], 1), np.concatenate([v, v], 1)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(causal=True, window=window, chunk=chunk, q_offset=q_offset)
    want = JA.gqa_attention(jq, jk, jv, **kw)
    got = TA.gqa_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("chunk", [16, 64])
def test_gqa_attention_bf16_matches_jax(chunk):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(S=56), dtype="bfloat16")
    want = _np(JA.gqa_attention(jq, jk, jv, causal=True, chunk=chunk))
    got = _np(TA.gqa_attention(tq, tk, tv, causal=True, chunk=chunk))
    _bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_and_update_cache_match_jax(dtype):
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    q, k, v = _qkv(B, S, H, KV, hd)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, dtype=dtype)
    lengths = np.array([32, 20], np.int32)
    jc = JA.update_cache(JA.init_kv_cache(B, 48, KV, hd, jnp.float32), jk, jv,
                         lengths=jnp.asarray(lengths))
    tc = TA.update_cache(TA.init_kv_cache(B, 48, KV, hd, torch.float32, device="cpu"),
                         tk, tv, lengths=torch.from_numpy(lengths))
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [32, 20]
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    # one decode token on top, per-slot positions
    jc = JA.update_cache(jc, jk[:, :1], jv[:, :1])
    tc = TA.update_cache(tc, tk[:, :1], tv[:, :1])
    assert tc.pos.tolist() == [33, 21]
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    want = _np(JA.decode_attention(jq[:, -1:], jc))
    got = _np(TA.decode_attention(tq[:, -1:], tc))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        _bf16_close(got, want)
    np.testing.assert_allclose(_np(TA.decode_attention(tq[:, -1:], tc, window=8)),
                               _np(JA.decode_attention(jq[:, -1:], jc, window=8)),
                               rtol=2e-5 if dtype == "float32" else 2e-2,
                               atol=2e-5 if dtype == "float32" else 2e-2)


def test_cache_insert_clamps_past_the_end():
    """A dead slot's counter runs past the cache end: the write start clamps
    (``dynamic_update_slice``), the counter does not."""
    k1 = np.ones((1, 1, 1, 4), np.float32)
    jc = JA.init_kv_cache(1, 4, 1, 4, jnp.float32)
    tc = TA.init_kv_cache(1, 4, 1, 4, torch.float32, device="cpu")
    for i in range(6):
        jc = JA.update_cache(jc, jnp.asarray(k1 * i), jnp.asarray(k1 * i))
        tc = TA.update_cache(tc, torch.from_numpy(k1 * i), torch.from_numpy(k1 * i))
    assert int(tc.pos[0]) == int(jc.pos[0]) == 6
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))


def test_quant_cache_matches_jax():
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    q, k, v = _qkv(B, S, H, KV, hd)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k * 3, v)
    jc = JA.update_quant_cache(JA.init_quant_kv_cache(B, 48, KV, hd), jk, jv,
                               lengths=jnp.asarray([32, 25], jnp.int32))
    tc = TA.update_quant_cache(TA.init_quant_kv_cache(B, 48, KV, hd, device="cpu"),
                               tk, tv, lengths=torch.tensor([32, 25], dtype=torch.int32))
    np.testing.assert_array_equal(tc.k_q.numpy(), np.asarray(jc.k_q))
    np.testing.assert_array_equal(tc.v_q.numpy(), np.asarray(jc.v_q))
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-7)
    assert tc.pos.tolist() == [32, 25]
    np.testing.assert_allclose(TA.decode_attention_quant(tq[:, -1:], tc).numpy(),
                               np.asarray(JA.decode_attention_quant(jq[:, -1:], jc)),
                               **F32)


_FA_CASES = [
    (2, 64, 4, 2, 16, 16, 16),   # GQA
    (1, 56, 4, 4, 16, 16, 16),   # MHA, non-divisible S
    (1, 128, 8, 1, 32, 32, 64),  # MQA, rectangular blocks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", _FA_CASES)
def test_flash_attention_matches_jax_kernel(dtype, causal, B, S, H, KV, hd, bq, bk):
    """K5's plain version (the CPU path of ``ops.flash_attention``) against
    the Pallas kernel in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B, S, H, KV, hd), dtype=dtype)
    tpm.reset_launches()
    want = _np(jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                    interpret=True))
    got = tops.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, hd)
    assert tpm.launches["flash_attention"] == 0  # the CPU path launches nothing
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        _bf16_close(_np(got), want)


def test_flash_attention_kernel_call_masks_pad_keys():
    """``sk_orig`` masks the keys past it, as the TPU kernel masks its pads."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 32, 16)).astype(np.float32)
    k = rng.standard_normal((2, 48, 16)).astype(np.float32)
    v = rng.standard_normal((2, 48, 16)).astype(np.float32)
    for causal in (True, False):
        want = np.asarray(j_k5(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, sk_orig=40, bq=16, bk=16, interpret=True))
        got = tfa.flash_attention_kernel_call(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), causal=causal,
                                              sk_orig=40)
        np.testing.assert_allclose(got.numpy(), want, **F32)


def test_flash_attention_matches_gqa_attention():
    """K5 computes the function the transformer's attention computes."""
    _, (tq, tk, tv) = _both(*_qkv(1, 100, 8, 2, 32))
    a = tops.flash_attention(tq, tk, tv, causal=True)
    b = TA.gqa_attention(tq, tk, tv, causal=True, chunk=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_flash_attention_wrapper_validates():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 8, 16)
    with pytest.raises(TypeError):
        tfa.flash_attention_kernel_call(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        tfa.flash_attention_kernel_call(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="sk_orig"):
        tfa.flash_attention_kernel_call(q, k, k, sk_orig=9)
    with pytest.raises(ValueError):
        tfa.flash_attention_kernel_call(q, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32))
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.flash_attention_kernel_call(q.requires_grad_(), k, k)
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention_kernel_call(q.detach().to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="group"):
        tops.flash_attention(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                             torch.zeros(1, 8, 2, 16))
