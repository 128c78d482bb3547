"""The port's CUDA kernels held to their plain twins on the card.

Imports torch only (the GPU machine has no JAX), so it runs there with
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
and skips, test by test, where no CUDA device is present. Shapes are
smollm-135m's serving shapes (9 heads over 3 KV heads, head_dim 64);
float32 at 2e-5, bf16 at 2e-2 (one bf16 rounding of outputs <= ~4).
svrg_update is held at float32 1e-6 (the JAX kernel test's own) and, in
bf16 / f16, to within one rounding of its twin (both compute in float32
and round once)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 paged_prefill_attention, ref, svrg_update)

pytestmark = pytest.mark.cuda

H, KV, HD, BS, M = 9, 3, 64, 16, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, *shape, dtype=torch.float32, dev="cpu"):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_matches_twin(cuda, dtype, tol):
    rng = np.random.default_rng(0)
    B = 8
    N = B * M + 1
    q = _rand(rng, B, H, HD, dtype=dtype, dev=cuda)
    kp = _rand(rng, N, BS, KV, HD, dtype=dtype, dev=cuda)
    vp = _rand(rng, N, BS, KV, HD, dtype=dtype, dev=cuda)
    bt = torch.from_numpy((1 + rng.permutation(B * M)).reshape(B, M)
                          .astype(np.int32)).to(cuda)
    ctx = torch.tensor([0, 1, 15, 16, 17, 100, 300, 512], dtype=torch.int32,
                       device=cuda)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, ctx)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[0] == 0)                       # ctx == 0


@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_paged_attention_quantized_pool_matches_twin(cuda, pool):
    rng = np.random.default_rng(1)
    B = 4
    N = B * M + 1
    q = _rand(rng, B, H, HD, dev=cuda)
    if pool == "int8":
        kq, vq = (torch.from_numpy(rng.integers(-127, 128, (N, BS, KV, HD))
                                   .astype(np.int8)).to(cuda)
                  for _ in range(2))
    else:
        kq, vq = (_rand(rng, N, BS, KV, HD, dev=cuda).mul(64)
                  .to(torch.float8_e4m3fn) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((N, BS, KV)) / 64)
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(B * M)).reshape(B, M)
                          .astype(np.int32)).to(cuda)
    ctx = torch.tensor([3, 64, 200, 511], dtype=torch.int32, device=cuda)
    got = paged_attention(q, kq, vq, bt, ctx, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(q, kq, vq, bt, ctx, ks, vs)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_paged_prefill_matches_twin(cuda, window):
    rng = np.random.default_rng(window)
    N, Ls = 4, 128
    P = N * M + 1
    q = _rand(rng, N, Ls, H, HD, dev=cuda)
    ks, vs = (_rand(rng, N, Ls, KV, HD, dev=cuda) for _ in range(2))
    kp, vp = (_rand(rng, P, BS, KV, HD, dev=cuda) for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(N * M)).reshape(N, M)
                          .astype(np.int32)).to(cuda)
    st = torch.tensor([0, 37, 256, 0], dtype=torch.int32, device=cuda)
    ln = torch.tensor([100, 165, 306, 0], dtype=torch.int32, device=cuda)
    args = (q, ks, vs, kp, vp, bt, st, ln)
    got = paged_prefill_attention(*args, window=window)
    torch.cuda.synchronize()
    want = ref.paged_prefill_ref(*args, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.all(got[3] == 0)                       # batch padding row


def test_paged_prefill_ignores_nonfinite_masked_pool(cuda):
    rng = np.random.default_rng(3)
    N, Ls = 2, 32
    P = N * M + 1
    q = _rand(rng, N, Ls, H, HD, dev=cuda)
    ks, vs = (_rand(rng, N, Ls, KV, HD, dev=cuda) for _ in range(2))
    kp, vp = (_rand(rng, P, BS, KV, HD, dev=cuda) for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(N * M)).reshape(N, M)
                          .astype(np.int32)).to(cuda)
    st = torch.tensor([20, 0], dtype=torch.int32, device=cuda)
    ln = torch.tensor([52, 32], dtype=torch.int32, device=cuda)
    clean = paged_prefill_attention(q, ks, vs, kp, vp, bt, st, ln)
    kp[bt[0, 1].long(), 4:] = float("nan")   # row 0 reads pool slots < 20
    vp[bt[0, 1].long(), 4:] = float("inf")
    kp[0], vp[0] = float("nan"), float("nan")
    dirty = paged_prefill_attention(q, ks, vs, kp, vp, bt, st, ln)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_twin(cuda, causal):
    rng = np.random.default_rng(int(causal))
    q = _rand(rng, 2, H, 512, HD, dev=cuda)
    k, v = (_rand(rng, 2, KV, 512, HD, dev=cuda) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_wrappers_raise_on_bad_inputs(cuda):
    q = torch.zeros(2, H, HD, device=cuda)
    pool = torch.zeros(5, BS, KV, HD, device=cuda)
    bt = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                      # dtype mismatch
        paged_attention(q, pool.bfloat16(), pool.bfloat16(), bt, ctx)
    with pytest.raises(ValueError):                     # not contiguous
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        pool, pool, bt, ctx)
    with pytest.raises(ValueError):                     # head_dim 32
        paged_attention(q[..., :32].contiguous(), pool[..., :32].contiguous(),
                        pool[..., :32].contiguous(), bt, ctx)
    with pytest.raises(ValueError):                     # tables on the CPU
        paged_attention(q, pool, pool, bt.cpu(), ctx)
    x = torch.zeros(1, H, 8, HD, device=cuda)
    kv = torch.zeros(1, KV, 8, HD, device=cuda)
    with pytest.raises(ValueError):                     # k/v on the CPU
        flash_attention(x, kv.cpu(), kv.cpu())


def _svrg_args(rng, n, dtype, dev, offset=0):
    """Five vectors of length n; with offset > 0 each is a view starting
    `offset` elements into its buffer (not 16-byte aligned)."""
    return [_rand(rng, n + offset, dtype=dtype, dev=dev)[offset:]
            for _ in range(5)]


@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (100003, 0), (17, 0),
                                      (4099, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7),
                                       (torch.float16, 2 ** -10)])
def test_svrg_update_matches_twin(cuda, n, offset, dtype, tol):
    """float32 within 1e-6 (1 + |twin|); bf16 / f16 within tol (1 + |twin|),
    tol being one ulp at 1 (8 and 11 significant bits): kernel and twin
    both round the same float32 value once."""
    rng = np.random.default_rng(n + offset)
    args = _svrg_args(rng, n, dtype, cuda, offset)
    assert all(a.is_contiguous() for a in args)
    before = svrg_update.launches
    got = svrg_update(*args, 0.1, 0.5)
    torch.cuda.synchronize()
    assert svrg_update.launches == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    want = ref.svrg_update_ref(*args, 0.1, 0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_svrg_update_raises_on_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    x, gx, gz, mu, w = _svrg_args(rng, 64, torch.float32, cuda)
    before = svrg_update.launches
    with pytest.raises(ValueError):                     # lengths differ
        svrg_update(x, gx, gz, mu[:63], w, 0.1, 0.5)
    with pytest.raises(ValueError):                     # 2-D
        svrg_update(x.view(8, 8), gx.view(8, 8), gz.view(8, 8),
                    mu.view(8, 8), w.view(8, 8), 0.1, 0.5)
    with pytest.raises(TypeError):                      # dtypes differ
        svrg_update(x, gx.bfloat16(), gz, mu, w, 0.1, 0.5)
    with pytest.raises(TypeError):                      # float64
        svrg_update(*(t.double() for t in (x, gx, gz, mu, w)), 0.1, 0.5)
    with pytest.raises(ValueError):                     # one on the CPU
        svrg_update(x, gx, gz, mu.cpu(), w, 0.1, 0.5)
    with pytest.raises(ValueError):                     # strided view
        svrg_update(x[::2], gx[::2], gz[::2], mu[::2], w[::2], 0.1, 0.5)
    assert svrg_update.launches == before
