"""The port's attention (plain version and the ``attend`` dispatch) against
the JAX reference's Pallas flash attention, on the CPU.

The reference runs its kernel in interpret mode (``L`` a multiple of its
block) and its jnp ``attention_ref``; a ragged ``L`` is held against
``attention_ref`` only, since the Pallas kernel cannot take it. Tolerances
are ``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2) times 4, as that file
scales them for attention.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, H, KV, L, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, L, hd), (B, KV, L, hd), (B, KV, L, hd))]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_flash(causal, G, hd, L, dtype):
    B, KV = 1, 2
    (jq, jk, jv), (q, k, v) = _qkv(L + hd + G, B, KV * G, KV, L, hd, dtype)
    got = attention_ref(q, k, v, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, jax_flash(jq, jk, jv, causal=causal, bq=64, bk=64, interpret=True),
           dtype)
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L", [100, 1, 37])
def test_ragged_length_matches_reference_oracle(L, causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(L, 2, 8, 2, L, 80, dtype)
    _close(attention_ref(q, k, v, causal=causal),
           jax_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_in_model_layout(causal):
    """``attend`` takes and returns the model's (B, L, heads, hd) layout; on
    CPU tensors it runs the plain version and launches nothing."""
    (jq, jk, jv), (q, k, v) = _qkv(5, 2, 8, 2, 64, 64, "float32")
    before = fa_mod.COUNTER.launches
    got = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    assert fa_mod.COUNTER.launches == before
    assert got.shape == (2, 64, 8, 64)
    _close(got.transpose(1, 2), jax_attention_ref(jq, jk, jv, causal=causal), "float32")


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _qkv(0, 1, 2, 2, 8, 64, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
