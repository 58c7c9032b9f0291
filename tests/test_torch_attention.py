"""heat_tpu_torch.ops.flash and heat_tpu_torch.nn.attention against
heat_tpu.ops.flash (the Pallas kernel in interpret mode) and
heat_tpu.nn.attention, on the CPU; the ring and Ulysses schedules on the
tests' CPU mesh (``HEAT_TPU_TEST_DEVICES`` shards) against heat_tpu's on
the JAX CPU mesh of the same size and against the port's dense path.

On the CPU the kernel's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Inputs are float32, made with numpy from a seed (conftest turns on x64, so
every array is cast explicitly). Tolerances:

* float32: 2e-4, the bound of tests/test_attention.py for the Pallas kernel
  against the dense oracle (the same math, summed in another order);
* bfloat16, plain version against the Pallas kernel: both round q, p and
  the output to bfloat16, but their f32 sums differ in order, so a rounding
  may go the other way: |Δ| ≤ 2⁻⁸·(max|v| + |ref|), two bfloat16 ulps of a
  weighted mean of v;
* gradients: rtol/atol 1e-4, as tests/test_ops_pallas.py holds the JAX
  custom VJP and tests/test_attention.py the ring's;
* ring and Ulysses in float32: 1e-5 against heat_tpu's and the dense path,
  the bound of tests/test_attention.py (the same online-softmax math over
  blocks, summed in another order); in bfloat16 within 0.05 of float32
  dense attention, as there.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.nn import attention as ref_attention
from heat_tpu.ops.flash import flash_attention_tpu
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.nn import attention
from heat_tpu_torch.ops import flash
from heat_tpu_torch.utils.interop import mha_from_flax

F32_TOL = 2e-4
SP_TOL = 1e-5
P = ht.communication._cpu_mesh_size()


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _qkv(B, S, H, D, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = S if sk is None else sk
    shapes = [(B, S, H, D), (B, sk, H, D), (B, sk, H, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(256, 16), (200, 16), (256, 128), (130, 8)])
def test_plain_matches_pallas_interpret(causal, S, D):
    arrays = _qkv(1, S, 2, D, seed=S + D)
    got = flash.flash_attention_plain(*_torch(arrays), causal=causal)
    want = flash_attention_tpu(*_jax(arrays), causal=causal, block_q=128, block_k=128, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (1, S, 2, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret_cross_attention(causal):
    arrays = _qkv(1, 70, 2, 16, seed=1, sk=300)
    got = flash.flash_attention_plain(*_torch(arrays), causal=causal)
    want = flash_attention_tpu(*_jax(arrays), causal=causal, interpret=True)
    assert got.shape == (1, 70, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_pallas_interpret_bf16():
    arrays = _qkv(1, 256, 2, 64, seed=7)
    got = flash.flash_attention_plain(*_torch(arrays, torch.bfloat16), causal=True)
    want = flash_attention_tpu(*_jax(arrays, jnp.bfloat16), causal=True, interpret=True)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want, np.float32)
    bound = 2.0**-8 * (np.abs(np.asarray(arrays[2], np.float32)).max() + np.abs(want32))
    assert (np.abs(got.float().numpy() - want32) <= bound).all()
    # and against the f32 dense oracle, to bfloat16 accuracy
    dense = ref_attention.dot_product_attention(*_jax(arrays), causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(dense), rtol=0.05, atol=0.05)


def test_plain_numerics_of_the_kernel():
    q, k, v = _torch(_qkv(2, 33, 3, 8, seed=2, sk=17))
    # the scale folds into q: a scale of 2 is q doubled
    torch.testing.assert_close(
        flash.flash_attention_plain(q, k, v, scale=2.0),
        flash.flash_attention_plain(2 * q, k, v, scale=1.0),
        rtol=0, atol=0,
    )
    # float16 and float64 compute in float32 and come back in their dtype
    for dtype in (torch.float16, torch.float64):
        out = flash.flash_attention_plain(q.to(dtype), k.to(dtype), v.to(dtype), causal=True)
        assert out.dtype == dtype
        ref = flash.flash_attention_plain(q.to(dtype).float(), k.to(dtype).float(), v.to(dtype).float(), causal=True)
        torch.testing.assert_close(out, ref.to(dtype), rtol=0, atol=0)
    # no key at all: every row is fully masked and comes out as 0, not NaN
    empty = flash.flash_attention_plain(q, k[:, :0], v[:, :0])
    assert empty.shape == q.shape and (empty == 0).all()
    # one query row, causal: it sees key 0 only
    one = flash.flash_attention_plain(q[:, :1], k, v, causal=True)
    torch.testing.assert_close(one, v[:, :1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the wrapper: CPU dispatch, checks, counter
# ---------------------------------------------------------------------------
def test_wrapper_dispatches_cpu_tensors_to_the_plain_version():
    q, k, v = _torch(_qkv(1, 40, 2, 24, seed=3))
    before = flash.LAUNCHES
    for causal in (False, True):
        got = flash.flash_attention_kernel(q, k, v, causal=causal, scale=0.3)
        plain = flash.flash_attention_plain(q, k, v, causal=causal, scale=0.3)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    out = attention.flash_attention(q, k, v, causal=True, impl="pallas")
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v, causal=True), rtol=0, atol=0)
    assert flash.LAUNCHES == before  # the plain version is no launch


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_qkv(1, 8, 2, 4, seed=4))
    big = torch.zeros(1, 8, 1, 513)
    for fn in (flash.flash_attention_kernel, flash.flash_attention_plain):
        with pytest.raises(ValueError, match="head_dim 513"):
            fn(big, big, big)
        with pytest.raises(ValueError):
            fn(q, k[:, :, :1], v[:, :, :1])  # H differs
        with pytest.raises(ValueError):
            fn(q, k, v[:, :5])  # k and v differ
        with pytest.raises(ValueError):
            fn(q[0], k[0], v[0])  # not [B, S, H, D]
        with pytest.raises(TypeError):
            fn(q.int(), k.int(), v.int())
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention(big, big, big, impl="pallas")
    with pytest.raises(ValueError, match="unknown flash impl"):
        attention.flash_attention(q, k, v, impl="mosaic")


# ---------------------------------------------------------------------------
# the tensor-core design: the TF32 split and the three-term products
# ---------------------------------------------------------------------------
def test_tf32_split_rounds_to_ten_mantissa_bits():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(
        (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))).astype(np.float32)
    )
    big, small = flash.tf32_split(x)
    assert big.dtype == small.dtype == torch.float32
    # 23 - 10 = 13 low mantissa bits are zero in both halves
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert (small.view(torch.int32) & 0x1FFF == 0).all()
    # round to nearest: |x - big| <= half a TF32 ulp, 2^-11 |x|
    assert ((x - big).abs() <= 2.0**-11 * x.abs()).all()
    # the pair carries x to within 2^-22 relative
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0**-22 * x.double().abs()).all()


def test_tf32_split_ties_go_away_from_zero():
    ulp = 2.0**-10  # a TF32 ulp at 1
    cases = [
        (1 + ulp / 2, 1 + ulp),  # a tie: away from zero (to even would give 1)
        (-(1 + ulp / 2), -(1 + ulp)),
        (1 + ulp / 2 - 2.0**-23, 1.0),  # just below the tie
        (1 + 3 * ulp / 2, 1 + 2 * ulp),  # a tie between odd and even: away again
        (1.5, 1.5),  # already a TF32 value
        (0.0, 0.0),
        (float("inf"), float("inf")),
    ]
    x = torch.tensor([c for c, _ in cases], dtype=torch.float32)
    want = torch.tensor([w for _, w in cases], dtype=torch.float32)
    big, small = flash.tf32_split(x)
    torch.testing.assert_close(big, want, rtol=0, atol=0)
    # a tie's remainder is exact: big + small == x
    torch.testing.assert_close(big[:2] + small[:2], x[:2], rtol=0, atol=0)
    assert small[0].item() == -ulp / 2 and small[1].item() == ulp / 2
    assert torch.isnan(flash.tf32_split(torch.tensor([float("nan")]))[0]).all()
    with pytest.raises(TypeError):
        flash.tf32_split(torch.zeros(2, dtype=torch.float64))


def _split_matmul(a, b, terms=3):
    """a @ b as the kernel's TF32 products, summed in float32: the small.big,
    big.small and big.big terms, or big.big alone with terms=1."""
    a_big, a_small = flash.tf32_split(a.contiguous())
    b_big, b_small = flash.tf32_split(b.contiguous())
    if terms == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _split_attention(q, k, v, causal, terms=3):
    """The kernel's f32 tensor-core arithmetic on the CPU: both products as
    split TF32 products, the scale folded into q, the -1e30 mask."""
    S, D, sk = q.shape[1], q.shape[3], k.shape[1]
    qs = (q * flash.score_scale(None, D)).permute(0, 2, 1, 3)
    s = _split_matmul(qs, k.permute(0, 2, 3, 1), terms)
    if causal:
        s = s.masked_fill(torch.arange(S)[:, None] < torch.arange(sk)[None, :], flash.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > flash.NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = _split_matmul(p, v.permute(0, 2, 1, 3), terms) / torch.where(l > 0, l, 1.0)
    return o.permute(0, 2, 1, 3)


@pytest.mark.parametrize("S,D,causal", [(256, 64, False), (200, 64, True), (130, 128, True)])
def test_three_term_tf32_attention_stays_within_f32_tolerance(S, D, causal):
    arrays = _qkv(1, S, 2, D, seed=S + D + 3)
    q, k, v = _torch(arrays)
    got = _split_attention(q, k, v, causal)
    plain = flash.flash_attention_plain(q, k, v, causal=causal)
    want = flash_attention_tpu(*_jax(arrays), causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    # one TF32 product (each operand rounded to 2^-11) does not hold the bound
    one = _split_attention(q, k, v, causal, terms=1)
    assert not np.allclose(one.numpy(), plain.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_kernel_design_is_chosen_by_head_dim_and_dtype():
    assert flash.kernel_design(1, torch.float32) == "wgmma_3xtf32"
    assert flash.kernel_design(64, torch.float32) == "wgmma_3xtf32"
    assert flash.kernel_design(128, torch.float16) == "wgmma_3xtf32"  # computed in f32
    assert flash.kernel_design(128, torch.float64) == "wgmma_3xtf32"
    assert flash.kernel_design(8, torch.bfloat16) == "mma_bf16"
    assert flash.kernel_design(128, torch.bfloat16) == "mma_bf16"
    assert flash.kernel_design(129, torch.float32) == "cuda_cores"
    assert flash.kernel_design(129, torch.bfloat16) == "cuda_cores"
    assert flash.kernel_design(512, torch.float32) == "cuda_cores"
    for bad in (0, 513):
        with pytest.raises(ValueError, match="head_dim"):
            flash.kernel_design(bad, torch.float32)


def test_kernel_gating():
    assert not flash.attention_kernel_supported(1024, 513)
    assert flash.attention_kernel_supported(1_000_000, 512) == torch.cuda.is_available()


def test_kernel_source_is_shipped_and_not_built_on_import():
    from heat_tpu_torch.ops import _build

    assert (_build.SOURCE_DIR / "flash.cu").is_file()
    assert "flash" not in _build._LOADED


# ---------------------------------------------------------------------------
# the oracles: dense and scan against their JAX counterparts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sk", [None, 23])
def test_dot_product_attention_matches_jax(causal, sk):
    arrays = _qkv(2, 19, 3, 8, seed=5, sk=sk)
    got = attention.dot_product_attention(*_torch(arrays), causal=causal)
    want = ref_attention.dot_product_attention(*_jax(arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,block", [(32, 8), (40, 16)])
def test_scan_flash_matches_jax(causal, S, block):
    arrays = _qkv(2, S, 2, 8, seed=S)
    got = attention.flash_attention(*_torch(arrays), causal=causal, block_size=block, impl="scan")
    want = ref_attention.flash_attention(*_jax(arrays), causal=causal, block_size=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    auto = attention.flash_attention(*_torch(arrays), causal=causal, block_size=block)
    torch.testing.assert_close(auto, got, rtol=0, atol=0)  # 'auto' is 'scan'


def test_pallas_custom_function_gradients_match_jax_dense():
    arrays = _qkv(1, 32, 2, 8, seed=9)
    q, k, v = (t.requires_grad_() for t in _torch(arrays))
    (attention._FlashPallasDiff.apply(q, k, v, True, None) ** 2).sum().backward()

    def loss(q, k, v):
        return (ref_attention.dot_product_attention(q, k, v, causal=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrays))
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MultiHeadAttention from the flax module's parameters
# ---------------------------------------------------------------------------
def _flax_mha(backend, seed=0, **fields):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    module = ref_attention.MultiHeadAttention(num_heads=4, causal=True, backend=backend, **fields)
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    return x, jax.tree_util.tree_map(np.asarray, variables["params"]), want


@pytest.mark.parametrize("backend", ["dense", "flash"])
def test_mha_matches_flax(backend):
    x, params, want = _flax_mha(backend)
    mha = mha_from_flax(params, causal=True, backend=backend, device="cpu")
    with torch.no_grad():
        got = mha(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mha_with_the_kernel_matches_flax_with_pallas_interpret():
    x, params, want = _flax_mha("dense", attention_fn=partial(flash_attention_tpu, interpret=True))
    mha = mha_from_flax(
        params, causal=True, attention_fn=partial(attention.flash_attention, impl="pallas"), device="cpu"
    )
    with torch.no_grad():
        got = mha(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mha_rejects_bad_widths_and_backends():
    with pytest.raises(ValueError, match="divisible"):
        ht.nn.MultiHeadAttention(3, 32, device="cpu")
    with pytest.raises(ValueError, match="unknown attention backend"):
        ht.nn.MultiHeadAttention(4, 32, backend="sparse", device="cpu")(torch.zeros(1, 4, 32))
    with pytest.raises(NotImplementedError, match="float16"):
        ht.nn.MultiHeadAttention(4, 32, dtype=torch.float16, device="cpu")


# ---------------------------------------------------------------------------
# ring and Ulysses over the tests' mesh (after tests/test_attention.py)
# ---------------------------------------------------------------------------
def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _sp_qkv(B=2, S=None, H=None, D=16, seed=0):
    # sequence and heads scale with the mesh, as tests/test_attention.py's
    return _qkv(B, 8 * P if S is None else S, 2 * P if H is None else H, D, seed)


def _reference(fn_name, arrays, dtype=jnp.float32, **kwargs):
    """heat_tpu's schedule on the JAX CPU mesh, inputs sharded along seq."""
    comm = ref.get_comm()
    sharded = [jax.device_put(a, comm.sharding(4, 1)) for a in _jax(arrays, dtype)]
    return getattr(ref_attention, fn_name)(*sharded, comm=comm, **kwargs)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_heat_tpu_and_dense(causal):
    arrays = _sp_qkv(seed=20)
    got = attention.ring_attention(*_torch(arrays), causal=causal, comm=ht.get_comm())
    want = _reference("ring_attention", arrays, causal=causal)
    dense = attention.dot_product_attention(*_torch(arrays), causal=causal)
    assert got.shape == dense.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SP_TOL, atol=SP_TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=SP_TOL, atol=SP_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_size", [0, 8], ids=["dense-local", "blockwise-local"])
def test_ulysses_matches_heat_tpu_and_dense(causal, block_size):
    arrays = _sp_qkv(seed=21)
    got = attention.ulysses_attention(*_torch(arrays), causal=causal, comm=ht.get_comm(), block_size=block_size)
    want = _reference("ulysses_attention", arrays, causal=causal, block_size=block_size)
    dense = attention.dot_product_attention(*_torch(arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SP_TOL, atol=SP_TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=SP_TOL, atol=SP_TOL)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_sequence_parallel_bf16_inputs_f32_accumulation(backend):
    arrays = _sp_qkv(seed=22)
    got = getattr(attention, f"{backend}_attention")(*_torch(arrays, torch.bfloat16), comm=ht.get_comm())
    # the f32 oracle on the bf16-rounded inputs
    dense = attention.dot_product_attention(*(t.float() for t in _torch(arrays, torch.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), dense.numpy(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_sequence_parallel_gradients_match_dense(backend):
    arrays = _sp_qkv(B=1, S=4 * P, H=2 * P, D=8, seed=23)
    fn = partial(getattr(attention, f"{backend}_attention"), comm=ht.get_comm())
    grads = []
    for attn in (fn, attention.dot_product_attention):
        leaves = [t.requires_grad_() for t in _torch(arrays)]
        (attn(*leaves, causal=True) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend,S,H", [("ring", 1, 2), ("ulysses", 0, 1), ("ulysses", 1, 0)],
                         ids=["ring-seq", "ulysses-heads", "ulysses-seq"])
def test_sequence_parallel_rejects_indivisible_shapes(backend, S, H):
    p = max(P, 2)  # every shape divides a one-shard mesh
    q, k, v = _torch(_qkv(1, 8 * p + S, 2 * p + H, 4, seed=24))
    with pytest.raises(ValueError, match="divisible"):
        getattr(attention, f"{backend}_attention")(q, k, v, comm=_mesh(p))


@pytest.mark.parametrize("backend", ["dense", "flash", "ring", "ulysses"])
def test_mha_backends_agree_with_flax_dense(backend):
    heads = 2 * P  # divisible for Ulysses at any mesh size
    x = np.random.default_rng(25).standard_normal((2, 8 * P, 4 * heads)).astype(np.float32)
    module = ref_attention.MultiHeadAttention(num_heads=heads, causal=True, backend="dense")
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    mha = mha_from_flax(params, causal=True, backend=backend, device="cpu")
    with torch.no_grad():
        got = mha(torch.from_numpy(x), comm=ht.get_comm())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_long_sequence_ring_keeps_shard_rows():
    # S = 1024 over p shards: every shard holds and returns 1024 / p rows
    p = P if 1024 % P == 0 else 8
    q, k, v = _torch(_qkv(1, 1024, 4, 8, seed=26))
    comm = _mesh(p)
    shards = attention._ring_shards(*(attention._split_seq(t, comm) for t in (q, k, v)), True,
                                    flash.score_scale(None, 8), comm)
    assert [tuple(s.shape) for s in shards] == [(1, 1024 // p, 4, 8)] * p
    out = attention.ring_attention(q, k, v, causal=True, comm=comm)
    torch.testing.assert_close(out, torch.cat(shards, dim=1), rtol=0, atol=0)
    dense = attention.dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=SP_TOL, atol=SP_TOL)
