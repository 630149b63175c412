"""The port's paged decode attention (plain version and the ``paged_attend``
dispatch) against the JAX reference's Pallas paged-attention kernel, run in
interpret mode as ``tests/test_kernels.py`` runs it, and its jnp
``paged_attention_ref``, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Tolerances
are ``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2) times 4, as that file
scales them for attention.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.paged_attention import paged_attention as jax_paged
from repro.kernels.flash_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.flash_attention import paged_attention as pa_mod
from repro_torch.kernels.flash_attention.ops import paged_attend
from repro_torch.kernels.flash_attention.ref import paged_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, KV, G, hd, ps, nb, q_dtype, page_dtype, layers=1):
    """numpy q, a (layers, num_pages, ps, KV, hd) K and V pool, a block table
    giving each row nb shuffled (non-contiguous) pages past the trash page 0,
    and ragged lengths — the recipe of tests/test_kernels.py's sweep."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((layers, num_pages, ps, KV, hd)).astype(np.float32)
    v = rng.standard_normal((layers, num_pages, ps, KV, hd)).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    lengths = np.asarray([(i * ps + i + 1) % (nb * ps) + 1 for i in range(B)], np.int32)
    return (q, q_dtype), (k, page_dtype), (v, page_dtype), table, lengths


def _jax(arr_dtype):
    arr, dtype = arr_dtype
    return jnp.asarray(arr).astype(dtype)


def _torch(arr_dtype):
    arr, dtype = arr_dtype
    return torch.from_numpy(arr).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)


@pytest.mark.parametrize("q_dtype,page_dtype", [("float32", "float32"),
                                                ("bfloat16", "bfloat16"),
                                                ("bfloat16", "float32")])
@pytest.mark.parametrize("B,KV,G,hd,ps,nb", [
    (2, 2, 2, 64, 8, 4),
    (3, 1, 4, 32, 16, 2),      # extreme GQA, two blocks
    (1, 4, 1, 64, 8, 3),       # one query head per KV head
    (2, 2, 4, 80, 16, 2),      # hd=80
])
def test_paged_attention_matches_pallas(B, KV, G, hd, ps, nb, q_dtype, page_dtype):
    """The plain version == the Pallas kernel (interpret mode) == the jnp
    oracle, over a shuffled pool with ragged lengths; bf16 q over f32 pages
    is the decode plane's main-path pairing (bf16 weights, f32 slot state).
    The output takes q's dtype, so its tolerance does."""
    q, k, v, table, lengths = _inputs(B * 7 + nb + hd, B, KV, G, hd, ps, nb,
                                      q_dtype, page_dtype)
    jq, jk, jv = _jax(q), _jax(k)[0], _jax(v)[0]
    got = paged_attention_ref(_torch(q), _torch(k)[0], _torch(v)[0],
                              torch.from_numpy(table), torch.from_numpy(lengths))
    assert got.dtype == getattr(torch, q_dtype) and got.shape == (B, KV, G, hd)
    _close(got, jax_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                          interpret=True), q_dtype)
    _close(got, jax_paged_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths)),
           q_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positions_past_length_do_not_leak(dtype):
    """Garbage (+-1e4) in a row's own pages past its length — the cells the
    overwrite invariant leaves stale — changes nothing, on both sides."""
    B, KV, G, hd, ps, nb = 1, 2, 2, 32, 8, 2
    q, k, v, _, _ = _inputs(3, B, KV, G, hd, ps, nb, dtype, dtype)
    table = np.asarray([[1, 2]], np.int32)
    lengths = np.asarray([5], np.int32)
    tq, tk, tv = _torch(q), _torch(k)[0], _torch(v)[0]
    args = (torch.from_numpy(table), torch.from_numpy(lengths))
    base = paged_attention_ref(tq, tk, tv, *args)
    tk[1, 5:], tk[2] = 1e4, -1e4
    tv[1, 5:], tv[2] = 1e4, -1e4
    poisoned = paged_attention_ref(tq, tk, tv, *args)
    torch.testing.assert_close(poisoned, base, atol=0, rtol=0)
    jpoisoned = jax_paged(_jax(q), jnp.asarray(tk.float().numpy()).astype(dtype),
                          jnp.asarray(tv.float().numpy()).astype(dtype),
                          jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    _close(poisoned, jpoisoned, dtype)


def test_trash_page_rows_and_a_pool_view():
    """Rows whose block table is all zeros read the trash page 0 (as inactive
    slots do) and match the reference; a per-layer view of the stacked
    (L, num_pages, ps, KV, hd) pool gives what a copy of that layer gives."""
    B, KV, G, hd, ps, nb = 3, 2, 4, 64, 4, 3
    q, k, v, table, lengths = _inputs(9, B, KV, G, hd, ps, nb, "float32", "float32",
                                      layers=3)
    table[1] = 0
    lengths[1] = 1
    tk, tv = _torch(k), _torch(v)
    args = (torch.from_numpy(table), torch.from_numpy(lengths))
    got = paged_attention_ref(_torch(q), tk[2], tv[2], *args)
    torch.testing.assert_close(got, paged_attention_ref(_torch(q), tk[2].clone(),
                                                        tv[2].clone(), *args))
    want = jax_paged(_jax(q), _jax(k)[2], _jax(v)[2], jnp.asarray(table),
                     jnp.asarray(lengths), interpret=True)
    _close(got, want, "float32")


def test_paged_attend_runs_the_plain_version_on_the_cpu():
    q, k, v, table, lengths = _inputs(1, 2, 2, 2, 64, 8, 4, "float32", "float32")
    args = (_torch(q), _torch(k)[0], _torch(v)[0], torch.from_numpy(table),
            torch.from_numpy(lengths))
    before = pa_mod.COUNTER.launches
    got = paged_attend(*args)
    assert pa_mod.COUNTER.launches == before
    torch.testing.assert_close(got, paged_attention_ref(*args), atol=0, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, table, lengths = _inputs(0, 1, 2, 2, 64, 8, 2, "float32", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_attention(_torch(q), _torch(k)[0], _torch(v)[0],
                               torch.from_numpy(table), torch.from_numpy(lengths))
