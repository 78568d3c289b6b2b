"""The port's flash attention and its ops against the JAX reference.

On the CPU the wrapper runs its plain version `attention_ref`; it is held
against the reference's Pallas kernel in interpret mode on the same numpy
inputs: f32 at atol 2e-5 and bf16 at 3e-2, the reference's own tolerances
for its kernel against its oracle. The card's kernel is checked by
tests/test_torch_gpu.py (and by chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as ref_flash
from repro.kernels.flash_attention.ops import gqa_attention as ref_gqa
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import chunked_attention


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def as_bf16(x):
    """numpy f32 → (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("bh,sq,skv,d", [
    (2, 128, 128, 64), (1, 256, 256, 32), (3, 128, 256, 64), (2, 64, 512, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_kernel(bh, sq, skv, d, causal):
    rng = np.random.default_rng(bh * sq)
    q, k, v = normal(rng, (bh, sq, d)), normal(rng, (bh, skv, d)), normal(rng, (bh, skv, d))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     bq=64, bk=64)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, bq=64, bk=64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_attention_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (as_bf16(normal(rng, (2, 128, 64))) for _ in range(3))
    want = ref_flash(qj, kj, vj, causal=True)
    got = flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(128, 128), (32, 96), (4, 64)])
def test_attention_ref_matches_reference_oracle(sq, skv, causal):
    rng = np.random.default_rng(sq + skv)
    q, k, v = normal(rng, (3, sq, 32)), normal(rng, (3, skv, 32)), normal(rng, (3, skv, 32))
    want = ref_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("sq,use_kernel", [(128, True), (128, False), (4, True)])
def test_gqa_attention_matches_reference(sq, use_kernel):
    """Hq 8 over Hkv 2. SQ = 4 < 8 takes the reference's plain version; the
    port sends every SQ to the wrapper, which runs the plain version here."""
    rng = np.random.default_rng(3)
    q = normal(rng, (2, 8, sq, 64))
    k, v = normal(rng, (2, 2, 128, 64)), normal(rng, (2, 2, 128, 64))
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   use_kernel=use_kernel)
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=True, use_kernel=use_kernel)
    assert tuple(got.shape) == (2, 8, sq, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_gqa_attention_plain_version_only_on_the_cpu():
    """use_kernel=False never reaches a plain version off the CPU."""
    q = torch.zeros(1, 4, 16, 32, device="meta")
    kv = torch.zeros(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        gqa_attention(q, kv, kv, use_kernel=False)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gqa_attention(q, kv, kv)


@pytest.mark.parametrize("sq,skv,chunks", [(128, 128, 64), (128, 256, 64), (256, 256, 128)])
def test_chunked_attention_matches_reference(sq, skv, chunks):
    rng = np.random.default_rng(sq)
    q = normal(rng, (2, 4, sq, 32))
    k, v = normal(rng, (2, 4, skv, 32)), normal(rng, (2, 4, skv, 32))
    want = ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                       q_chunk=chunks, k_chunk=chunks)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=True, q_chunk=chunks, k_chunk=chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_chunked_attention_bf16_matches_reference():
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = (as_bf16(normal(rng, (1, 2, 128, 64))) for _ in range(3))
    want = ref_chunked(qj, kj, vj, causal=True, q_chunk=32, k_chunk=64)
    got = chunked_attention(qt, kt, vt, causal=True, q_chunk=32, k_chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(2, 96, 32)
    kv = torch.zeros(2, 96, 32)
    with pytest.raises(ValueError, match="multiples of their blocks"):
        flash_attention(q, kv, kv, bq=64, bk=64)     # 96 % 64 != 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="BH or D"):
        flash_attention(q, torch.zeros(3, 96, 32), torch.zeros(3, 96, 32))


def test_other_devices_raise_and_cpu_calls_are_not_launches():
    """Only a CPU tensor reaches the plain version; a tensor elsewhere
    raises, and CPU calls never count as kernel launches."""
    meta = torch.zeros(1, 64, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(meta, meta, meta)
    before = flash_attention.launches
    x = torch.ones(1, 64, 32)
    flash_attention(x, x, x)
    assert flash_attention.launches == before
