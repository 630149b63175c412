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
    (2, 2, 16, 128, 8, 3),     # 16 query heads a KV head (qwen3-moe-235b-a22b)
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


# ---------------------------------------------------------------------------
# The CUDA kernel's split-and-merge algebra, written out in f64
# ---------------------------------------------------------------------------


def _split_merge(q, k_pages, v_pages, table, lengths, pps, arrival_seed=0):
    """csrc/paged_attention.cu's partition, in f64 torch: the row's pages cut
    into splits of ``pps`` pages; a split past the length exits; each live
    split runs an online softmax over tiles of ``TILE`` positions (masked
    scores -1e30, positions past the split's end zero-filled) to its
    (m, l, acc); one live split writes acc / max(l, 1e-30); otherwise the
    splits arrive in a shuffled order, each adds one to the (row, head)'s
    counter, and the one that finds live - 1 folds every live split, in
    split order, into a running (M, L, O) and sets the counter back to 0."""
    B, KV, G, hd = q.shape
    ps, nb = k_pages.shape[1], table.shape[1]
    qf = q.double() * hd ** -0.5
    kf, vf = k_pages.double(), v_pages.double()
    splits, span = -(-nb // pps), pps * ps
    out = torch.zeros(B, KV, G, hd, dtype=torch.float64)
    counters = torch.zeros(B, KV, dtype=torch.int64)
    order = np.random.default_rng(arrival_seed)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), nb * ps)
        live = 1 if n == 0 else -(-n // span)
        for h in range(KV):
            parts = {}
            for s in range(splits):
                if s >= live:
                    continue
                start = s * span
                end = min(start + span, n)
                m = torch.full((G,), -1e30, dtype=torch.float64)
                l = torch.zeros(G, dtype=torch.float64)
                acc = torch.zeros(G, hd, dtype=torch.float64)
                for p0 in range(start, end, pa_mod.TILE):
                    pos = torch.arange(p0, p0 + pa_mod.TILE)
                    kept = pos < end
                    at = pos.clamp(max=end - 1)
                    page = torch.as_tensor(table[b])[at // ps].long()
                    kt = torch.where(kept[:, None], kf[page, at % ps, h], 0.0)
                    vt = torch.where(kept[:, None], vf[page, at % ps, h], 0.0)
                    sc = torch.where(kept[None, :], qf[b, h] @ kt.T, -1e30)   # (G, TILE)
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                parts[s] = (m, l, acc)
            if live == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / l.clamp(min=1e-30)[:, None]
                continue
            merged = 0
            for s in order.permutation(live):
                last = int(counters[b, h]) == live - 1
                counters[b, h] += 1
                if last:        # one online pass over the splits, in order
                    M = torch.full((G,), -1e30, dtype=torch.float64)
                    L = torch.zeros(G, dtype=torch.float64)
                    O = torch.zeros(G, hd, dtype=torch.float64)
                    for i in range(live):
                        m_i, l_i, acc_i = parts[i]
                        mn = torch.maximum(M, m_i)
                        keep, c = torch.exp(M - mn), torch.exp(m_i - mn)
                        L, O, M = L * keep + l_i * c, O * keep[:, None] + acc_i * c[:, None], mn
                    out[b, h] = O / L.clamp(min=1e-30)[:, None]
                    counters[b, h] = 0
                    merged += 1
            assert merged == 1
    assert not counters.any()
    return out


# lengths at and around page (ps = 4), tile (16) and split boundaries (pps
# 1, 2 and 16 pages: 4, 8 and 64 positions), 0, nb * ps = 80, and past it
_EDGE_LENGTHS = [0, 1, 4, 7, 8, 9, 15, 16, 17, 31, 33, 63, 64, 65, 79, 80, 95]


@pytest.mark.parametrize("pps", [1, 2, 16, 23])          # 23 > nb = 20: one split
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("hd", [32, 80])
def test_split_merge_algebra_matches_the_references(pps, G, hd):
    """The kernel's split-and-merge, in f64, == the plain version == the jnp
    oracle on every row of length >= 1, and == the Pallas kernel (interpret
    mode) on every row; a row of length 0 gives zeros, as the Pallas kernel
    does (the dense oracles average over the masked positions there)."""
    B, KV, ps, nb = len(_EDGE_LENGTHS), 2, 4, 20
    q, k, v, table, _ = _inputs(pps * 100 + G * 10 + hd, B, KV, G, hd, ps, nb,
                                "float32", "float32")
    lengths = np.asarray(_EDGE_LENGTHS, np.int32)
    got = _split_merge(_torch(q), _torch(k)[0], _torch(v)[0], table, lengths, pps,
                       arrival_seed=pps + G)
    nz = lengths > 0
    assert torch.equal(got[~torch.from_numpy(nz)], torch.zeros_like(got[~torch.from_numpy(nz)]))
    plain = paged_attention_ref(_torch(q), _torch(k)[0], _torch(v)[0],
                                torch.from_numpy(table), torch.from_numpy(lengths))
    _close(got[nz].float(), np.asarray(plain)[nz], "float32")
    jq, jk, jv = _jax(q), _jax(k)[0], _jax(v)[0]
    jt, jl = jnp.asarray(table), jnp.asarray(lengths)
    _close(got[nz].float(), np.asarray(jax_paged_ref(jq, jk, jv, jt, jl))[nz], "float32")
    _close(got.float(), jax_paged(jq, jk, jv, jt, jl, interpret=True), "float32")


@pytest.mark.parametrize("B,KV,nb,ps,sms", [
    (8, 4, 256, 16, 132), (8, 4, 16, 16, 132), (1, 1, 1, 1, 132), (3, 2, 7, 4, 132),
    (1, 8, 1000, 16, 132), (64, 8, 64, 16, 132), (2, 1, 37, 1, 16), (5, 3, 100, 32, 1),
    (65535, 8, 128, 16, 132)])
def test_split_plan_covers_every_page_once(B, KV, nb, ps, sms):
    pps, splits, grid = pa_mod.split_plan(B, KV, nb, ps, sms)
    covered = [p for s in range(splits) for p in range(s * pps, min((s + 1) * pps, nb))]
    assert covered == list(range(nb))                    # in order, each once
    assert 1 <= pps <= nb and (splits - 1) * pps < nb     # no split is empty
    assert pps * ps >= min(pa_mod.TILE, nb * ps)          # a tile's worth where it can
    assert grid == (splits * KV, B)


def test_split_plan_grid_stays_within_cuda_limits_at_b_65535():
    pps, splits, (gx, gy) = pa_mod.split_plan(65535, 8, 4096, 16, 132)
    assert splits == 1 and pps == 4096                   # enough blocks without splitting
    assert gy <= pa_mod.MAX_GRID_Y and gx <= 2 ** 31 - 1


@pytest.mark.parametrize("nb,pps,blocks", [(256, 16, 512), (16, 1, 512)])
def test_split_plan_at_chip_smoke_shapes(nb, pps, blocks):
    """The long rows (nb 256) and the decode cell (nb 16) of chip_smoke.py
    phase 3 (B 8, KV 4, ps 16) on the H100's 132 SMs: 16 splits a row, 512
    blocks (PERF.md section 6)."""
    got_pps, splits, (gx, gy) = pa_mod.split_plan(8, 4, nb, 16, 132)
    assert (got_pps, splits, gx * gy) == (pps, 16, blocks)
