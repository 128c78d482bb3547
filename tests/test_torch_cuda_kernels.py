"""The port's CUDA kernels held to their plain twins on the card.

Imports torch only (the GPU machine has no JAX), so it runs there with
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
and skips, test by test, where no CUDA device is present. Shapes are
smollm-135m's serving shapes (9 heads over 3 KV heads, head_dim 64);
float32 at 2e-5, bf16 at 2e-2 (one bf16 rounding of outputs <= ~4)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 paged_prefill_attention, ref)

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
