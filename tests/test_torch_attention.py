"""The port's relative-position attention (k2transducerasr_tpu_torch/ops/
attention*.py) against the JAX package on the CPU.

``relpos_attn_probs_reference`` and ``relpos_attn_ctx_reference`` (the plain
PyTorch versions of the CUDA kernels K1 and K2) are held against the JAX
Pallas kernels run in interpret mode, over the mask regimes of
tests/test_attention_pallas.py.  Inputs come from numpy seeds.  Tolerance:
float32 probs and ctx agree to atol 1e-5 on valid query rows (the two sum
q.k in different orders); bf16 probs to one bf16 ulp below 1.0 (2**-7), bf16
ctx to one bf16 ulp of the output (rtol 2**-7; both round one float32 sum of
the same bf16-rounded probs, which can differ by one ulp where float32
summation order flips a rounding: atol 2**-9 * max|v|).  Rows at invalid
queries differ by design and are skipped (both mask keys only, and every
caller zeroes those rows).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k2transducerasr_tpu.ops import attention as JA
from k2transducerasr_tpu.ops import attention_pallas as JP
from k2transducerasr_tpu_torch.ops import attention as TA
from k2transducerasr_tpu_torch.ops import attention_cuda as TC
from k2transducerasr_tpu_torch.ops import cuda_build

F32_ATOL = 1e-5
BF16_ATOL = 2.0**-7


def _inputs(seed, b, t, s, h, qd, pd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, qd)).astype(np.float32)
    k = rng.standard_normal((b, s, h, qd)).astype(np.float32)
    pq = rng.standard_normal((b, t, h, pd)).astype(np.float32)
    pk = rng.standard_normal((t + s - 1, h, pd)).astype(np.float32)
    return q, k, pq, pk


# (b, t, s, h, qd, pd, lens, extra kwargs, block_t of the JAX kernel)
GRID = [
    pytest.param(2, 100, 100, 4, 32, 4, [100, 57], {}, 256, id="ragged-lens"),
    pytest.param(1, 130, 130, 8, 32, 4, [93], {}, 32, id="partial-block-8-heads"),
    pytest.param(3, 48, 48, 4, 16, 4, [48, 1, 20], {}, 256, id="lens-1"),
    pytest.param(2, 96, 96, 4, 32, 4, None, {"chunk": 16, "left": 32}, 32, id="chunk-left"),
    pytest.param(3, 8, 40, 4, 32, 4, None, {"kv_start": [32, 10, 0]}, 256, id="kv-start-T-ne-S"),
]


@pytest.mark.parametrize("b,t,s,h,qd,pd,lens,kw,block_t", GRID)
def test_reference_matches_pallas_interpret(b, t, s, h, qd, pd, lens, kw, block_t):
    q, k, pq, pk = _inputs(b * 1000 + t, b, t, s, h, qd, pd)
    kv = kw.get("kv_start")
    jkw = dict(kw, kv_start=None if kv is None else jnp.asarray(kv, jnp.int32))
    want = np.asarray(JP.relpos_attn_probs(
        q, k, pq, pk, None if lens is None else jnp.asarray(lens, jnp.int32),
        block_t=block_t, interpret=True, **jkw))
    tkw = dict(kw, kv_start=None if kv is None else torch.tensor(kv, dtype=torch.int32))
    got = TC.relpos_attn_probs_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pq), torch.from_numpy(pk),
        None if lens is None else torch.tensor(lens, dtype=torch.int32), **tkw).numpy()
    assert got.shape == want.shape == (b, h, t, s)
    for i in range(b):
        rows = t if lens is None else lens[i]
        np.testing.assert_allclose(got[i, :, :rows], want[i, :, :rows], atol=F32_ATOL)


def test_reference_bf16_output_matches_pallas_interpret():
    b, t, h, qd, pd = 2, 64, 4, 32, 4
    q, k, pq, pk = (x.astype(jnp.bfloat16) for x in _inputs(7, b, t, t, h, qd, pd))
    lens = [64, 33]
    want = np.asarray(JP.relpos_attn_probs(
        q, k, pq, pk, jnp.asarray(lens, jnp.int32), interpret=True)).astype(np.float32)
    tq, tk, tpq, tpk = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                        for x in (q, k, pq, pk))
    got = TC.relpos_attn_probs_reference(tq, tk, tpq, tpk, torch.tensor(lens))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for i in range(b):
        np.testing.assert_allclose(got[i, :, : lens[i]], want[i, :, : lens[i]], atol=BF16_ATOL)


def test_fully_masked_row_is_uniform():
    q, k, pq, pk = (torch.from_numpy(x) for x in _inputs(3, 1, 8, 40, 2, 8, 4))
    out = TC.relpos_attn_probs_reference(q, k, pq, pk, torch.tensor([5]),
                                         kv_start=torch.tensor([20]))
    torch.testing.assert_close(out, torch.full_like(out, 1.0 / 40), atol=1e-7, rtol=0)


@pytest.mark.parametrize("fn", [TC.relpos_attn_probs, TC.relpos_attn_probs_reference],
                         ids=["wrapper", "reference"])
def test_contract_value_errors(fn):
    q, k, pq, pk = (torch.from_numpy(x) for x in _inputs(0, 1, 8, 8, 2, 4, 2))
    with pytest.raises(ValueError, match="pos_k rows"):
        fn(q, k, pq, pk[:-1], None)
    q2, k2, pq2, pk2 = (torch.from_numpy(x) for x in _inputs(0, 1, 8, 12, 2, 4, 2))
    with pytest.raises(ValueError, match="chunk-causal requires t == s"):
        fn(q2, k2, pq2, pk2, None, chunk=4, left=4)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    q, k, pq, pk = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 16, 2, 8, 4))
    lens = torch.tensor([16, 9])
    before = TC.relpos_attn_probs.launches
    got = TC.relpos_attn_probs(q, k, pq, pk, lens, chunk=4, left=8)
    want = TC.relpos_attn_probs_reference(q, k, pq, pk, lens, chunk=4, left=8)
    assert torch.equal(got, want)
    assert TC.relpos_attn_probs.launches == before


# (b, t, s, h, qd, pd, vd, lens, extra kwargs): K2's regimes, tiny because the
# interpret mode is slow
CTX_GRID = [
    pytest.param(3, 40, 40, 2, 16, 16, 16, [40, 1, 23], {}, id="ragged-lens-incl-1"),
    pytest.param(2, 48, 48, 2, 8, 8, 8, [48, 30], {"chunk": 8, "left": 16}, id="chunk-left"),
    pytest.param(3, 8, 40, 2, 8, 8, 8, None, {"kv_start": [32, 10, 0]}, id="kv-start-T-ne-S"),
    pytest.param(2, 32, 32, 2, 8, 4, 24, [32, 20], {}, id="vd-ne-qd"),
]


def _ctx_inputs(seed, b, t, s, h, qd, pd, vd):
    q, k, pq, pk = _inputs(seed, b, t, s, h, qd, pd)
    v = np.random.default_rng(seed + 1).standard_normal((b, s, h, vd)).astype(np.float32)
    return q, k, pq, pk, v


def _jax_ctx(q, k, pq, pk, v, lens, kw):
    kv = kw.get("kv_start")
    jkw = dict(kw, kv_start=None if kv is None else jnp.asarray(kv, jnp.int32))
    return JP.relpos_attn_ctx(q, k, pq, pk, v, None if lens is None else jnp.asarray(
        lens, jnp.int32), interpret=True, **jkw)


def _torch_kw(kw):
    kv = kw.get("kv_start")
    return dict(kw, kv_start=None if kv is None else torch.tensor(kv, dtype=torch.int32))


@pytest.mark.parametrize("b,t,s,h,qd,pd,vd,lens,kw", CTX_GRID)
def test_ctx_reference_matches_pallas_interpret(b, t, s, h, qd, pd, vd, lens, kw):
    q, k, pq, pk, v = _ctx_inputs(b * 100 + t + vd, b, t, s, h, qd, pd, vd)
    want = np.asarray(_jax_ctx(q, k, pq, pk, v, lens, kw))
    got = TC.relpos_attn_ctx_reference(
        *(torch.from_numpy(x) for x in (q, k, pq, pk, v)),
        None if lens is None else torch.tensor(lens, dtype=torch.int32), **_torch_kw(kw)).numpy()
    assert got.shape == want.shape == (b, t, h, vd)
    for i in range(b):
        rows = t if lens is None else min(lens[i], t)
        np.testing.assert_allclose(got[i, :rows], want[i, :rows], atol=F32_ATOL, rtol=0)


def test_ctx_reference_bf16_matches_pallas_interpret():
    b, t, h, qd, vd = 2, 32, 2, 16, 16
    q, k, pq, pk, v = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in _ctx_inputs(11, b, t, t, h, qd, qd, vd))
    lens = [32, 17]
    want = np.asarray(_jax_ctx(q, k, pq, pk, v, lens, {}).astype(jnp.float32))
    tq, tk, tpq, tpk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                            for x in (q, k, pq, pk, v))
    got = TC.relpos_attn_ctx_reference(tq, tk, tpq, tpk, tv, torch.tensor(lens))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    atol = 2.0**-9 * float(np.abs(np.asarray(v, np.float32)).max())
    for i in range(b):
        np.testing.assert_allclose(got[i, : lens[i]], want[i, : lens[i]], rtol=2.0**-7,
                                   atol=atol)


def test_ctx_out_dtype_and_fully_masked_row():
    """out_dtype is honoured; a lane whose keys are all masked gives the mean
    of v over all S (NEG_INF is finite), as the TPU kernel does."""
    q, k, pq, pk, v = (torch.from_numpy(x) for x in _ctx_inputs(3, 1, 8, 40, 2, 8, 4, 6))
    out = TC.relpos_attn_ctx_reference(q, k, pq, pk, v, torch.tensor([5]),
                                       kv_start=torch.tensor([20]))
    want = v.mean(dim=1, keepdim=True).expand(1, 8, 2, 6)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
    out16 = TC.relpos_attn_ctx(q, k, pq, pk, v, None, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and out16.shape == (1, 8, 2, 6)


@pytest.mark.parametrize("fn", [TC.relpos_attn_ctx, TC.relpos_attn_ctx_reference],
                         ids=["wrapper", "reference"])
def test_ctx_contract_value_errors(fn):
    q, k, pq, pk, v = (torch.from_numpy(x) for x in _ctx_inputs(0, 1, 8, 8, 2, 4, 2, 4))
    with pytest.raises(ValueError, match="pos_k rows"):
        fn(q, k, pq, pk[:-1], v, None)
    with pytest.raises(ValueError, match="v shape"):
        fn(q, k, pq, pk, v[:, :-1], None)
    q2, k2, pq2, pk2, v2 = (torch.from_numpy(x) for x in _ctx_inputs(0, 1, 8, 12, 2, 4, 2, 4))
    with pytest.raises(ValueError, match="chunk-causal requires t == s"):
        fn(q2, k2, pq2, pk2, v2, None, chunk=4, left=4)


def test_ctx_wrapper_on_cpu_runs_plain_version_without_counting():
    q, k, pq, pk, v = (torch.from_numpy(x) for x in _ctx_inputs(1, 2, 16, 16, 2, 8, 4, 12))
    lens = torch.tensor([16, 9])
    before = TC.relpos_attn_ctx.launches
    got = TC.relpos_attn_ctx(q, k, pq, pk, v, lens, chunk=4, left=8)
    want = TC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, chunk=4, left=8)
    assert torch.equal(got, want)
    assert TC.relpos_attn_ctx.launches == before


def test_ctx_reference_equals_probs_times_v():
    """K2's plain version is K1's plain probs times v (the TPU kernels' shared
    body), here in float32 where the cast to v's dtype is exact."""
    q, k, pq, pk, v = (torch.from_numpy(x) for x in _ctx_inputs(4, 2, 12, 12, 3, 8, 8, 5))
    lens = torch.tensor([12, 7])
    probs = TC.relpos_attn_probs_reference(q, k, pq, pk, lens, chunk=4, left=4)
    want = torch.einsum("bhts,bshd->bthd", probs, v)
    got = TC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, chunk=4, left=4)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["relpos_attn_probs", "relpos_attn_ctx"])
def test_library_name_follows_source_and_flags(name, monkeypatch):
    """The build is keyed by the source bytes and nvcc flags: an edited source
    or changed flags never load a stale library.  No nvcc is needed."""
    with open(cuda_build.source_path(name), "rb") as f:
        source = f.read()
    path = cuda_build.library_path(name)
    assert path == cuda_build.library_path(name, source)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith(f"lib{name}_") and path.endswith(".so")
    assert cuda_build.library_path(name, source + b"\n") != path
    assert cuda_build.library_path("other", source) != path
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build.library_path(name, source) != path


def test_kernel_rows_fit_shared_memory():
    """The float32 body keeps one tile of 256 keys in shared memory, not
    whole score rows (which stopped S at 11,249): its bytes depend on the
    rows and pd only, and at 8 rows and the widest pos head (pd = 64) stay
    inside the 227 KB an H100 block may use."""
    assert TC._probs_rows(torch.float32, 11250) == 8
    assert TC._probs_rows(torch.float32, 3) == 3
    assert TC._smem_bytes(8, 4) == 4 * (8 * 64 + 8 * 64 + 263 * 4 + 8 * 256)
    assert TC._smem_bytes(8, 64) <= 227 * 1024


@pytest.mark.parametrize("t,s", [(6, 6), (4, 11)])
def test_rel_shift_matches_jax(t, s):
    x = np.random.default_rng(t + s).standard_normal((2, 3, t, t + s - 1)).astype(np.float32)
    want = np.asarray(JA.rel_shift(jnp.asarray(x), s))
    got = TA.rel_shift(torch.from_numpy(x), s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_positions_and_chunk_mask_match_jax():
    np.testing.assert_array_equal(TA.descending_rel_positions(5, 9).numpy(),
                                  np.asarray(JA.descending_rel_positions(5, 9)))
    np.testing.assert_array_equal(TA.chunk_causal_mask(20, 4, 8).numpy(),
                                  np.asarray(JA.chunk_causal_mask(20, 4, 8)))


def test_mask_from_specs_matches_jax():
    b, t = 3, 12
    lens = np.array([12, 7, 1], np.int32)
    kv = np.array([0, 3, 5], np.int32)
    want = np.asarray(JP.mask_from_specs(b, t, t, jnp.asarray(lens), (4, 4), jnp.asarray(kv)))
    got = TC.mask_from_specs(b, t, t, torch.from_numpy(lens), (4, 4), torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), want)
    assert TC.mask_from_specs(b, t, t) is None
