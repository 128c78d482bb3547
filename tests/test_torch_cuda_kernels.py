"""The port's CUDA kernels held to their plain twins on the card.

Imports torch only (the GPU machine has no JAX), so it runs there with
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
and skips, test by test, where no CUDA device is present. Shapes are
smollm-135m's serving shapes (9 heads over 3 KV heads, head_dim 64), the
other head dims the configs have (16 reduced, 80 stablelm-3b, 256
recurrentgemma-2b), and rwkv6-3b's (40 heads of 64); float32 at 2e-5, bf16
at 2e-2 (one bf16 rounding of outputs <= ~4). svrg_update is held at
float32 1e-6 (the JAX kernel test's own) and, in bf16 / f16, to within one
rounding of its twin (both compute in float32 and round once); rwkv6_scan
at float32 1e-5 (1 + |twin|), bf16 2 ulps, and its float32 state bit for
bit, and its y bit for bit to ref.rwkv6_scan_split_ref (the kernel's
order of the sum). The tensor-core flash kernel (bf16 / f16) is held at
2e-2 at every head dim, the tensor-core paged_prefill kernel at 2 bf16
ulps at every head dim and block size, over 16-bit and int8 / fp8 pools
(NaN codes and scales in masked slots adding nothing); paged decode's split is held bit
for bit where the output must not move (a row alone or in any batch, a
non-finite pool past ctx, ctx = 1 giving the token's V row), and each
wrapper that reads with TMA gives the aligned call's bits on bf16 views
off a 16-byte boundary. The flash backward kernel is held to
ref.flash_attention_bwd_ref at every head dim: float32 within 2e-5 of
max(1, max |twin|), bf16 / f16 within 2 bf16 ulps, two launches
bit-equal; the wrappers without a backward raise under autograd."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 paged_prefill_attention, ref, svrg_update)
from repro_torch.kernels import rglru_scan  # noqa: E402
from repro_torch.kernels import rwkv6_scan  # noqa: E402

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


# ----------------------------------------------------------------------------
# recurrentgemma-2b's shapes: 10 query heads over 1 KV head, head_dim 256,
# local window; the RG-LRU scan at rnn_width 2560
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(300, 128), (300, 0), (2304, 2048)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_hd256_window_matches_twin(cuda, S, window, dtype, tol):
    rng = np.random.default_rng(S + window)
    q = _rand(rng, 1, 10, S, 256, dtype=dtype, dev=cuda)
    k, v = (_rand(rng, 1, 1, S, 256, dtype=dtype, dev=cuda)
            for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_group10_hd256_matches_twin(cuda, dtype, tol):
    """generate()'s dense decode of an attn_local layer: one 2048-slot
    block per row (the rolling buffer), ragged contexts."""
    rng = np.random.default_rng(10)
    B, n = 4, 2048
    q = _rand(rng, B, 10, 256, dtype=dtype, dev=cuda)
    kp, vp = (_rand(rng, B, n, 1, 256, dtype=dtype, dev=cuda)
              for _ in range(2))
    bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ctx = torch.tensor([n, 1500, 97, 1], dtype=torch.int32, device=cuda)
    got = paged_attention(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(q, kp, vp, bt, ctx)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _on_card(t, offset):
    """t copied to the card, `offset` elements into a larger buffer: a
    contiguous view that is 16-byte aligned only where offset * itemsize
    is a multiple of 16."""
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device="cuda")
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _unaligned_case(wrapper, cuda):
    """(wrapper, its bf16 arguments, the positions of the inputs it reads
    with TMA) at smollm's shapes: paged decode over 8 ragged rows, the
    4 x 128 paged_prefill admission, the 2 x 512 causal flash."""
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    if wrapper == "paged_attention":
        B = 8
        bt = torch.from_numpy((1 + rng.permutation(B * M)).reshape(B, M)
                              .astype(np.int32)).to(cuda)
        ctx = torch.tensor([0, 1, 15, 16, 17, 100, 300, 512],
                           dtype=torch.int32, device=cuda)
        return paged_attention, (
            _rand(rng, B, H, HD, dtype=bf, dev=cuda),
            *(_rand(rng, B * M + 1, BS, KV, HD, dtype=bf, dev=cuda)
              for _ in range(2)), bt, ctx), (0, 1, 2)
    if wrapper == "paged_prefill":
        N, Ls = 4, 128
        bt = torch.from_numpy((1 + rng.permutation(N * M)).reshape(N, M)
                              .astype(np.int32)).to(cuda)
        st = torch.tensor([0, 48, 200, 0], dtype=torch.int32, device=cuda)
        ln = torch.tensor([128, 176, 300, 0], dtype=torch.int32,
                          device=cuda)
        return paged_prefill_attention, (
            _rand(rng, N, Ls, H, HD, dtype=bf, dev=cuda),
            *(_rand(rng, N, Ls, KV, HD, dtype=bf, dev=cuda)
              for _ in range(2)),
            *(_rand(rng, N * M + 1, BS, KV, HD, dtype=bf, dev=cuda)
              for _ in range(2)), bt, st, ln), (0, 1, 2, 3, 4)
    return flash_attention, (
        _rand(rng, 2, H, 512, HD, dtype=bf, dev=cuda),
        *(_rand(rng, 2, KV, 512, HD, dtype=bf, dev=cuda)
          for _ in range(2))), (0, 1, 2)


@pytest.mark.parametrize("wrapper", ["paged_attention", "paged_prefill",
                                     "flash_attention"])
@pytest.mark.parametrize("moved", ["each", "all"])
def test_unaligned_bf16_views_give_the_aligned_bits(cuda, wrapper, moved):
    """A bf16 input that is a contiguous view one element (2 bytes) off a
    16-byte boundary is copied before the TMA reads (build.tma_ready): the
    result is the aligned call's bit for bit, in one launch."""
    fn, args, tma = _unaligned_case(wrapper, cuda)
    want = fn(*args)
    for which in ([(i,) for i in tma] if moved == "each" else [tma]):
        views = tuple(_on_card(a, 1) if i in which else a
                      for i, a in enumerate(args))
        assert all(views[i].data_ptr() % 16 == 2 for i in which)
        before = fn.launches
        got = fn(*views)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# both kernels of csrc/rglru_scan.cu: the bulk kernel (T >= 64, rows of
# 16-byte multiples at aligned addresses) at its chunk edges 64 / 65, at
# lm.forward's 1 x 2304 and at C = 2564 in float32 (a last tile of 4
# channels); the direct
# kernel at decode (B = 4, 8), under a chunk (13, 63), at odd widths
# (2561, 13; 2564 in 16-bit), at a view one element into its buffer, and
# at T = 0 (h_T = h0)
@pytest.mark.parametrize("B,T,C,offset", [
    (2, 512, 2560, 0), (4, 1, 2560, 0), (1, 13, 2560, 0), (1, 63, 2560, 0),
    (1, 64, 2560, 0), (1, 65, 2560, 0), (1, 2304, 2560, 0),
    (2, 100, 2561, 0), (2, 100, 13, 0), (2, 100, 2560, 1), (2, 0, 2560, 0),
    (8, 1, 2560, 0), (1, 100, 2564, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bit_equal_to_twin(cuda, B, T, C, offset, dtype,
                                      with_h0):
    """Kernel and twin round each step's multiply and add on their own in
    float32 and round h_seq once to x's dtype: equal bits, whichever
    kernel the route picks."""
    rng = np.random.default_rng(B * T + C + offset)
    a = _on_card(torch.sigmoid(_rand(rng, B, T, C) * 2).to(dtype), offset)
    x = _on_card((_rand(rng, B, T, C) * 0.3).to(dtype), offset)
    h0 = _rand(rng, B, C, dev=cuda) if with_h0 else None
    kernel, _ = rglru_scan.plan(a, x)
    assert kernel == ("bulk" if T >= 64 and offset == 0
                      and C * dtype.itemsize % 16 == 0 else "direct")
    before = rglru_scan.launches
    got, got_h = rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert got.dtype == dtype and got_h.dtype == torch.float32
    want, want_h = ref.rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_h, want_h, atol=0, rtol=0)


def test_rglru_scan_raises_on_bad_inputs(cuda):
    a = torch.zeros(2, 4, 8, device=cuda)
    before = rglru_scan.launches
    with pytest.raises(ValueError):                     # shapes differ
        rglru_scan(a, a[:, :3].contiguous())
    with pytest.raises(ValueError):                     # dtypes differ
        rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError):                     # h0 not float32
        rglru_scan(a, a, torch.zeros(2, 8, device=cuda).bfloat16())
    with pytest.raises(ValueError):                     # strided
        rglru_scan(a[:, ::2], a[:, ::2])
    with pytest.raises(TypeError):                      # float64
        rglru_scan(a.double(), a.double())
    assert rglru_scan.launches == before


# ----------------------------------------------------------------------------
# the head dims the configs have besides 64: 16 (every .reduced()), 80
# (stablelm-3b), and 256 in paged_prefill (recurrentgemma-2b's)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("hd,heads", [(16, (4, 2)), (80, (32, 32)),
                                      (256, (10, 1))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernels_at_every_head_dim(cuda, hd, heads, dtype, tol):
    """flash (causal, windowed, full), paged decode over ragged contexts
    and paged prefill over a cached prefix, each against its twin."""
    h, kv = heads
    rng = np.random.default_rng(hd)
    q = _rand(rng, 2, h, 200, hd, dtype=dtype, dev=cuda)
    k, v = (_rand(rng, 2, kv, 200, hd, dtype=dtype, dev=cuda)
            for _ in range(2))
    for causal, window in ((True, 0), (False, 0), (True, 48)):
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    B, m = 4, 8
    P = B * m + 1
    qd = _rand(rng, B, h, hd, dtype=dtype, dev=cuda)
    kp, vp = (_rand(rng, P, BS, kv, hd, dtype=dtype, dev=cuda)
              for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(B * m)).reshape(B, m)
                          .astype(np.int32)).to(cuda)
    ctx = torch.tensor([0, 1, 13, 64], dtype=torch.int32, device=cuda)
    got = paged_attention(qd, kp, vp, bt, ctx)
    want = ref.paged_attention_ref(qd, kp, vp, bt, ctx)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    N, Ls = 3, 16
    qp = _rand(rng, N, Ls, h, hd, dtype=dtype, dev=cuda)
    ks, vs = (_rand(rng, N, Ls, kv, hd, dtype=dtype, dev=cuda)
              for _ in range(2))
    st = torch.tensor([0, 8, 0], dtype=torch.int32, device=cuda)
    ln = torch.tensor([16, 24, 9], dtype=torch.int32, device=cuda)
    for window in (0, 6):
        args = (qp, ks, vs, kp, vp, bt[:N], st, ln)
        got = paged_prefill_attention(*args, window=window)
        want = ref.paged_prefill_ref(*args, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# rwkv6-3b's time mix: 40 heads of 64, float32 state; and the reduced 16
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 40, 1, 64), (2, 40, 300, 64),
                                   (2, 4, 40, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_matches_twin(cuda, shape, dtype, with_s0):
    """y within float32 1e-5 (1 + |twin|) or 2 bf16 ulps (only the order
    of the sum over the key channel differs); S_T bit for bit (each state
    element's multiply and add are rounded on their own in both)."""
    B, H, T, N = shape
    rng = np.random.default_rng(T * N + with_s0)
    r, k, v = (_rand(rng, *shape, dev=cuda).mul(0.5).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(_rand(rng, *shape, dev=cuda) - 1))
    u = _rand(rng, H, N, dev=cuda) * 0.1
    s0 = _rand(rng, B, H, N, N, dev=cuda) if with_s0 else None
    before = rwkv6_scan.launches
    got, got_s = rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert got.dtype == dtype and got_s.dtype == torch.float32
    want, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert bool((diff <= 1e-5 * (1 + want.abs())).all())
    else:
        _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -8))
        assert bool((diff <= 2 * torch.ldexp(torch.ones_like(diff),
                                             e - 8)).all())
    torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)


def test_rwkv6_scan_raises_on_bad_inputs(cuda):
    r = torch.zeros(1, 2, 3, 16, device=cuda)
    w, u = torch.zeros_like(r), torch.zeros(2, 16, device=cuda)
    before = rwkv6_scan.launches
    with pytest.raises(ValueError):                     # shapes differ
        rwkv6_scan(r, r[:, :, :2].contiguous(), r, w, u)
    with pytest.raises(TypeError):                      # k dtype differs
        rwkv6_scan(r, r.bfloat16(), r, w, u)
    with pytest.raises(ValueError):                     # w not float32
        rwkv6_scan(r.bfloat16(), r.bfloat16(), r.bfloat16(), w.bfloat16(), u)
    with pytest.raises(ValueError):                     # s0 misshapen
        rwkv6_scan(r, r, r, w, u, torch.zeros(1, 2, 16, 8, device=cuda))
    with pytest.raises(ValueError):                     # strided
        rwkv6_scan(r[:, :, ::2], r[:, :, ::2], r[:, :, ::2], w[:, :, ::2], u)
    with pytest.raises(ValueError):                     # head dim 128
        big = torch.zeros(1, 1, 2, 128, device=cuda)
        rwkv6_scan(big, big, big, big, torch.zeros(1, 128, device=cuda))
    with pytest.raises(ValueError):                     # u on the CPU
        rwkv6_scan(r, r, r, w, u.cpu())
    assert rwkv6_scan.launches == before


@pytest.mark.parametrize("N,offset", [(1, 0), (12, 0), (60, 0), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_pads_any_head_dim(cuda, N, offset, dtype, with_s0):
    """Head dims that are not a multiple of 8, and inputs that are not
    16-byte aligned (a view one element into its buffer), go through
    pad_head_dim and the same kernel: S_T bit for bit the twin's, y bit for
    bit the split emulation's on the unpadded inputs; one launch."""
    B, H, T = 2, 4, 40
    shape = (B, H, T, N)
    rng = np.random.default_rng(N + offset + with_s0)
    r, k, v = (_on_card(_rand(rng, *shape).mul(0.5).to(dtype), offset)
               for _ in range(3))
    w = _on_card(torch.exp(-torch.exp(_rand(rng, *shape) - 1)), offset)
    u = _rand(rng, H, N, dev=cuda) * 0.1
    s0 = _rand(rng, B, H, N, N, dev=cuda) if with_s0 else None
    before = rwkv6_scan.launches
    got, got_s = rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert got.shape == shape and got_s.shape == (B, H, N, N)
    assert got.is_contiguous() and got_s.is_contiguous()
    want, _ = ref.rwkv6_scan_split_ref(r, k, v, w, u, s0)
    _, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)


# ----------------------------------------------------------------------------
# flash_attention's tensor-core kernel (bf16 / f16) at every head dim, and
# paged_attention's flash-decoding split
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S", [1, 40, 300])
def test_flash_wgmma_matches_twin(cuda, hd, dtype, S):
    """Causal, non-causal and windowed, 4 query heads over 2 KV heads;
    ragged q tiles (Sq = 1, 40, 300 against 64-row tiles) and key tiles
    (300 keys against 64 or 32); at the bf16 tolerance, 2e-2."""
    rng = np.random.default_rng(hd * 1000 + S)
    q = _rand(rng, 2, 4, S, hd, dtype=dtype, dev=cuda)
    k, v = (_rand(rng, 2, 2, S, hd, dtype=dtype, dev=cuda) for _ in range(2))
    for causal, window in ((True, 0), (False, 0), (True, 48)):
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def _paged_batch(rng, dtype, dev, hd, heads, bs, ctx):
    """B = len(ctx) rows; bs = 2048 is generate()'s one block per row,
    otherwise an engine pool of 32 blocks a row, shuffled."""
    h, kv = heads
    B = len(ctx)
    if bs == 2048:
        N, bt = B, np.arange(B, dtype=np.int32)[:, None]
    else:
        N = B * M + 1
        bt = (1 + rng.permutation(B * M)).reshape(B, M).astype(np.int32)
    q = _rand(rng, B, h, hd, dtype=dtype, dev=dev)
    kp, vp = (_rand(rng, N, bs, kv, hd, dtype=dtype, dev=dev)
              for _ in range(2))
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("hd,heads,bs,ctx", [
    (64, (9, 3), BS, [0, 1, 17, 128, 129, 256, 333, 512]),
    (256, (10, 1), 2048, [2048, 1, 700, 1500, 128, 0]),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 300])
def test_paged_attention_batch_invariant(cuda, hd, heads, bs, ctx, dtype,
                                         window):
    """A row's output bits do not depend on the batch: alone, in the
    batch, and in the batch with the other rows' contexts changed; with
    and without a window (which leaves out whole splits and, in the first
    live one, the rows below it)."""
    rng = np.random.default_rng(hd + bs)
    q, kp, vp, bt, cl = _paged_batch(rng, dtype, cuda, hd, heads, bs, ctx)
    full = paged_attention(q, kp, vp, bt, cl, window=window)
    for b in range(len(ctx)):
        alone = paged_attention(q[b:b + 1], kp, vp, bt[b:b + 1], cl[b:b + 1],
                                window=window)
        torch.testing.assert_close(alone[0], full[b], atol=0, rtol=0)
        moved = cl.roll(1)                # every other row's ctx changed
        moved[b] = cl[b]
        others = paged_attention(q, kp, vp, bt, moved, window=window)
        torch.testing.assert_close(others[b], full[b], atol=0, rtol=0)
    torch.testing.assert_close(full.float(), ref.paged_attention_ref(
        q, kp, vp, bt, cl, window=window).float(),
        atol=2e-5 if dtype == torch.float32 else 2e-2,
        rtol=2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_chunk_boundaries(cuda, dtype, tol):
    """Contexts at, one short of and one past a multiple of the 128-token
    split, inside generate()'s 2048-slot blocks, and past the table (ctx
    is clamped to M * bs)."""
    ctx = [127, 128, 129, 255, 256, 257, 2047, 2048, 4000]
    rng = np.random.default_rng(7)
    q, kp, vp, bt, cl = _paged_batch(rng, dtype, cuda, 64, (9, 3), 2048,
                                     ctx)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, cl)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("hd,heads", [(64, (9, 3)), (256, (10, 1))])
def test_paged_attention_ctx_0_and_1(cuda, hd, heads):
    """ctx 0 gives zeros; ctx 1 gives the one token's V row exactly (its
    softmax weight is 1)."""
    rng = np.random.default_rng(hd)
    q, kp, vp, bt, cl = _paged_batch(rng, torch.float32, cuda, hd, heads,
                                     BS, [0, 1, 0, 1])
    got = paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    h, kv = heads
    assert torch.all(got[0] == 0) and torch.all(got[2] == 0)
    for b in (1, 3):
        v0 = vp[bt[b, 0].long(), 0]                      # (KV, hd)
        torch.testing.assert_close(
            got[b], v0.repeat_interleave(h // kv, dim=0), atol=0, rtol=0)


@pytest.mark.parametrize("hd,heads,bs", [(64, (9, 3), BS),
                                         (256, (10, 1), 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_ignores_nonfinite_masked_pool(cuda, hd, heads, bs,
                                                       dtype):
    """NaN / inf in every pool slot at or past a row's ctx (and in the
    null block) leave the result bit for bit the same."""
    ctx = [5, 130, 0, 300]
    rng = np.random.default_rng(11)
    q, kp, vp, bt, cl = _paged_batch(rng, dtype, cuda, hd, heads, bs, ctx)
    clean = paged_attention(q, kp, vp, bt, cl)
    kd, vd = kp.clone(), vp.clone()
    used = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for b, c in enumerate(ctx):
        t = torch.arange(c, device=cuda)
        used[bt[b, t // bs].long(), t % bs] = True
    kd[~used] = float("nan")
    vd[~used] = float("inf")
    dirty = paged_attention(q, kd, vd, bt, cl)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_paged_attention_quantized_group10_hd256(cuda, pool):
    """1-byte pools with per-(slot, KV head) scales at recurrentgemma's
    decode shape (q in shared memory), contexts over several splits;
    float32 at 2e-5."""
    rng = np.random.default_rng(12)
    B, n = 3, 2048
    q = _rand(rng, B, 10, 256, dev=cuda)
    if pool == "int8":
        kq, vq = (torch.from_numpy(rng.integers(-127, 128, (B, n, 1, 256))
                                   .astype(np.int8)).to(cuda)
                  for _ in range(2))
    else:
        kq, vq = (_rand(rng, B, n, 1, 256, dev=cuda).mul(64)
                  .to(torch.float8_e4m3fn) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((B, n, 1)) / 64)
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ctx = torch.tensor([2048, 300, 1], dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    got = paged_attention(q, kq, vq, bt, ctx, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kq, vq, bt, ctx, ks, vs)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ----------------------------------------------------------------------------
# paged_prefill's tensor-core kernel (bf16 / f16 q and pool) and the
# rwkv6_scan redesign
# ----------------------------------------------------------------------------

def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of max(|want|, 2^-8): chip_smoke.py's
    measure."""
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -8))
    return (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()


_PREFILL_HEADS = {16: (4, 2), 64: (9, 3), 80: (32, 32), 128: (16, 4),
                  256: (10, 1)}


def _prefill_args(rng, dtype, dev, hd, bs, starts, counts, Ls):
    """N = len(starts) rows; bs = 2048 is one block a row, otherwise a pool
    of 512 / bs blocks a row, shuffled; lengths = starts + counts."""
    h, kv = _PREFILL_HEADS[hd]
    n = len(starts)
    m = max(1, 512 // bs)
    P = n * m + 1
    q = _rand(rng, n, Ls, h, hd, dtype=dtype, dev=dev)
    ks, vs = (_rand(rng, n, Ls, kv, hd, dtype=dtype, dev=dev)
              for _ in range(2))
    kp, vp = (_rand(rng, P, bs, kv, hd, dtype=dtype, dev=dev)
              for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(n * m)).reshape(n, m)
                          .astype(np.int32)).to(dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = st + torch.tensor(counts, dtype=torch.int32, device=dev)
    return q, ks, vs, kp, vp, bt, st, ln


_PREFILL_CASES = {
    # an admission: a fresh prompt, cached prefixes, a padding row
    "admission": ([0, 48, 200, 0], [128, 128, 100, 0], 128),
    # speculate=4's verify chains over contexts up to 500
    "verify": ([0, 3, 17, 100, 250, 400, 500, 311],
               [0, 1, 2, 4, 5, 3, 5, 0], 5),
    # a short bucket with a partial last pool block
    "bucket": ([160, 0, 33, 7], [10, 16, 12, 3], 16),
}


@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bs", [4, 8, 16, 2048])
def test_paged_prefill_wgmma_matches_twin(cuda, hd, dtype, bs):
    """Every case (windows 0 and 64) within 2 bf16 ulps of the float32
    twin; lengths == 0 rows give zeros; one launch each."""
    rng = np.random.default_rng(hd * 10 + bs)
    for name, (starts, counts, Ls) in _PREFILL_CASES.items():
        args = _prefill_args(rng, dtype, cuda, hd, bs, starts, counts, Ls)
        for window in (0, 64):
            before = paged_prefill_attention.launches
            got = paged_prefill_attention(*args, window=window)
            torch.cuda.synchronize()
            assert paged_prefill_attention.launches == before + 1
            want = ref.paged_prefill_ref(*args, window=window)
            assert got.dtype == dtype and bool(torch.isfinite(got).all())
            assert _bf16_ulps(got, want) <= 2, (name, window)
            for n, (s_, c_) in enumerate(zip(starts, counts)):
                if s_ == 0 and c_ == 0:
                    assert torch.all(got[n] == 0)


@pytest.mark.parametrize("bs", [4, 16, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_prefill_wgmma_ignores_nonfinite_masked_pool(cuda, bs, dtype):
    """NaN / inf in every pool slot a row may not see (past its starts, in
    its partial last block, the null block) and in the suffix past its
    lengths leave the result bit for bit the same."""
    rng = np.random.default_rng(bs)
    starts, counts, Ls = [20, 0, 61, 5], [32, 32, 3, 0], 32
    q, ks, vs, kp, vp, bt, st, ln = _prefill_args(rng, dtype, cuda, 64, bs,
                                                  starts, counts, Ls)
    clean = paged_prefill_attention(q, ks, vs, kp, vp, bt, st, ln)
    used = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for n, s_ in enumerate(starts):
        t = torch.arange(s_, device=cuda)
        used[bt[n, t // bs].long(), t % bs] = True
    kd, vd, ksd, vsd = kp.clone(), vp.clone(), ks.clone(), vs.clone()
    kd[~used] = float("nan")
    vd[~used] = float("inf")
    for n, c_ in enumerate(counts):
        ksd[n, c_:] = float("nan")
        vsd[n, c_:] = float("nan")
    dirty = paged_prefill_attention(q, ksd, vsd, kd, vd, bt, st, ln)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


# paged_prefill over int8 / fp8 pools: bf16 / f16 q on the tensor-core
# kernel (the codes converted exactly to q's dtype, the scales on S's and
# P's columns), float32 q on the CUDA-core kernel
_QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quantized(args, pool):
    """The case's pools quantized as the engine lands them
    (attention.quantize_kv); returns (args, k_scale, v_scale)."""
    from repro_torch.models.attention import quantize_kv
    (kq, ksc), (vq, vsc) = (quantize_kv(p_.float(), _QUANT[pool])
                            for p_ in args[3:5])
    return (*args[:3], kq, vq, *args[5:]), ksc, vsc


@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("bs", [4, 16, 2048])
def test_paged_prefill_wgmma_quantized_pool_matches_twin(cuda, hd, dtype,
                                                         pool, bs):
    """Every case (windows 0 and 64) over a quantized pool within 2 bf16
    ulps of the float32 twin and bit-equal across two launches; lengths
    == 0 rows give zeros; each call one launch, counted in launches and
    in quant_launches."""
    rng = np.random.default_rng(hd * 10 + bs + len(pool))
    for name, (starts, counts, Ls) in _PREFILL_CASES.items():
        args, ksc, vsc = _quantized(
            _prefill_args(rng, dtype, cuda, hd, bs, starts, counts, Ls), pool)
        for window in (0, 64):
            kw = dict(k_scale=ksc, v_scale=vsc, window=window)
            before = (paged_prefill_attention.launches,
                      paged_prefill_attention.quant_launches)
            got = paged_prefill_attention(*args, **kw)
            torch.cuda.synchronize()
            assert (paged_prefill_attention.launches,
                    paged_prefill_attention.quant_launches) == (
                        before[0] + 1, before[1] + 1)
            want = ref.paged_prefill_ref(*args, ksc, vsc, window=window)
            assert got.dtype == dtype and bool(torch.isfinite(got).all())
            assert _bf16_ulps(got, want) <= 2, (name, window)
            assert torch.equal(got, paged_prefill_attention(*args, **kw))
            for n, (s_, c_) in enumerate(zip(starts, counts)):
                if s_ == 0 and c_ == 0:
                    assert torch.all(got[n] == 0)


@pytest.mark.parametrize("bs", [4, 16, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_paged_prefill_wgmma_quantized_ignores_nan_in_masked_slots(
        cuda, bs, dtype, pool):
    """NaN scales (and, in an fp8 pool, NaN codes) in every pool slot a
    row may not see leave the result bit for bit the same: the kernel
    stages code 0 and scale 0 there, since 0 times NaN is NaN on the
    tensor cores."""
    rng = np.random.default_rng(bs + 7)
    starts, counts, Ls = [20, 0, 61, 5], [32, 32, 3, 0], 32
    args, ksc, vsc = _quantized(_prefill_args(rng, dtype, cuda, 64, bs,
                                              starts, counts, Ls), pool)
    q, ks, vs, kp, vp, bt, st, ln = args
    clean = paged_prefill_attention(*args, k_scale=ksc, v_scale=vsc)
    used = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for n, s_ in enumerate(starts):
        t = torch.arange(s_, device=cuda)
        used[bt[n, t // bs].long(), t % bs] = True
    kd, vd, ksd, vsd = kp.clone(), vp.clone(), ksc.clone(), vsc.clone()
    ksd[~used] = float("nan")
    vsd[~used] = float("nan")
    if pool == "fp8":
        kd.view(torch.uint8)[~used] = 0x7F
        vd.view(torch.uint8)[~used] = 0xFF
    dirty = paged_prefill_attention(q, ks, vs, kd, vd, bt, st, ln,
                                    k_scale=ksd, v_scale=vsd)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_paged_prefill_float32_q_over_quantized_pool_on_cuda_cores(cuda,
                                                                   pool):
    """float32 q over an int8 / fp8 pool: the CUDA-core kernel (the
    tensor-core entry refuses float32 q, the CUDA-core entry 16-bit q),
    within float32's 2e-5 of the twin, one launch, one quantized."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_prefill import route
    assert route(torch.float32) == "cuda_cores"
    assert route(torch.bfloat16) == route(torch.float16) == "wgmma"
    rng = np.random.default_rng(11)
    args, ksc, vsc = _quantized(_prefill_args(
        rng, torch.float32, cuda, 64, 16, *_PREFILL_CASES["admission"]),
        pool)
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.quant_launches)
    got = paged_prefill_attention(*args, k_scale=ksc, v_scale=vsc)
    torch.cuda.synchronize()
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.quant_launches) == (before[0] + 1,
                                                         before[1] + 1)
    torch.testing.assert_close(
        got, ref.paged_prefill_ref(*args, ksc, vsc), atol=2e-5, rtol=2e-5)
    q, ks, vs, kp, vp, bt, st, ln = args
    out = torch.empty_like(q)
    codes = build.DTYPE_CODES
    N, Ls, H_, hd = q.shape
    P, bs, KV_, _ = kp.shape
    shape = (N, Ls, H_, KV_, hd)
    # the tensor-core entry refuses float32 q ...
    err = build.load("paged_prefill", "paged_prefill_wgmma")(
        q.data_ptr(), ks.data_ptr(), vs.data_ptr(), kp.data_ptr(),
        vp.data_ptr(), ksc.data_ptr(), vsc.data_ptr(), bt.data_ptr(),
        st.data_ptr(), ln.data_ptr(), out.data_ptr(), codes[torch.float32],
        codes[kp.dtype], *shape, P, bs, bt.shape[1], 0, hd ** -0.5,
        build.stream())
    assert err != 0
    # ... and the CUDA-core entry bf16 q
    qb, ksb, vsb = (t.bfloat16() for t in (q, ks, vs))
    err = build.load("paged_prefill")(
        qb.data_ptr(), ksb.data_ptr(), vsb.data_ptr(), kp.data_ptr(),
        vp.data_ptr(), ksc.data_ptr(), vsc.data_ptr(), bt.data_ptr(),
        st.data_ptr(), ln.data_ptr(), qb.data_ptr(), codes[torch.bfloat16],
        codes[kp.dtype], *shape, bs, bt.shape[1], 0, hd ** -0.5,
        build.stream())
    assert err != 0


@pytest.mark.parametrize("shape", [(4, 40, 1, 64), (2, 40, 300, 64),
                                   (1, 40, 2048, 64), (2, 4, 40, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_bit_equal_to_split_emulation(cuda, shape, dtype,
                                                 with_s0):
    """y bit for bit the serial emulation's (one chain over the key rows in
    order), S_T bit for bit the twin's."""
    B, H, T, N = shape
    rng = np.random.default_rng(T + N + with_s0)
    r, k, v = (_rand(rng, *shape, dev=cuda).mul(0.5).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(_rand(rng, *shape, dev=cuda) - 1))
    u = _rand(rng, H, N, dev=cuda) * 0.1
    s0 = _rand(rng, B, H, N, N, dev=cuda) if with_s0 else None
    got, got_s = rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    want, _ = ref.rwkv6_scan_split_ref(r, k, v, w, u, s0)
    _, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)


# ----------------------------------------------------------------------------
# the serving engine's arms of two kernels: paged decode with a sliding
# window (recurrentgemma-2b's attn_local layers over their paged history)
# and rwkv6_scan's per-step states (speculative verify's rollback points)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("window", [48, 200, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_window_matches_twin(cuda, window, dtype, tol):
    """recurrentgemma-2b's decode shape (10 query heads over 1 KV head, hd
    256) through an engine pool of 16-token blocks, contexts on both sides
    of the window and of the 128-token splits: within the kernel tolerance
    of the windowed twin; rows with ctx <= window bit-equal to the call
    without a window."""
    rng = np.random.default_rng(window)
    ctx = [0, 1, window - 1, window, window + 1, window + 127, window + 129,
           3000]
    B, bs, Mw = len(ctx), 16, 3000 // 16 + 1
    N = B * Mw + 1
    q = _rand(rng, B, 10, 256, dtype=dtype, dev=cuda)
    kp, vp = (_rand(rng, N, bs, 1, 256, dtype=dtype, dev=cuda)
              for _ in range(2))
    bt = torch.from_numpy((1 + rng.permutation(B * Mw)).reshape(B, Mw)
                          .astype(np.int32)).to(cuda)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, bt, cl, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, bt, cl, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[0] == 0)                       # ctx == 0
    plain = paged_attention(q, kp, vp, bt, cl)
    inside = cl <= window
    torch.testing.assert_close(got[inside], plain[inside], atol=0, rtol=0)
    # a window wider than every row is no window at all
    wide = paged_attention(q, kp, vp, bt, cl, window=4096)
    torch.testing.assert_close(wide, plain, atol=0, rtol=0)


def _rwkv_inputs(rng, shape, dtype, dev, with_s0):
    B, H, T, N = shape
    r, k, v = (_rand(rng, *shape, dev=dev).mul(0.5).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(_rand(rng, *shape, dev=dev) - 1))
    u = _rand(rng, H, N, dev=dev) * 0.1
    s0 = _rand(rng, B, H, N, N, dev=dev) if with_s0 else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("shape", [(4, 40, 8, 64), (4, 40, 1, 64),
                                   (2, 4, 5, 12), (2, 3, 40, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_states_bit_equal(cuda, shape, dtype, with_s0):
    """return_states=True: one launch; y and S_T bit-equal to the call
    without the flag; S_steps bit-equal to the twin's, each S_steps[:, :,
    t] to S_T of the call cut to t + 1 steps and to t + 1 single-step
    launches chained through s0 (the engine's decode steps); aligned (N =
    64, 16) and padded (N = 12)."""
    B, H, T, N = shape
    rng = np.random.default_rng(T * N + 7 * with_s0)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, shape, dtype, cuda, with_s0)
    before = rwkv6_scan.launches
    y, s_fin, steps = rwkv6_scan(r, k, v, w, u, s0, return_states=True)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert steps.shape == (B, H, T, N, N) and steps.dtype == torch.float32
    y0, s0_fin = rwkv6_scan(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y0, atol=0, rtol=0)
    torch.testing.assert_close(s_fin, s0_fin, atol=0, rtol=0)
    _, _, want = ref.rwkv6_scan_ref(r, k, v, w, u, s0, return_states=True)
    torch.testing.assert_close(steps, want, atol=0, rtol=0)
    torch.testing.assert_close(steps[:, :, -1], s_fin, atol=0, rtol=0)
    s = s0
    for t in range(T):
        cut = [x[:, :, :t + 1].contiguous() for x in (r, k, v, w)]
        _, s_cut = rwkv6_scan(*cut, u, s0)
        torch.testing.assert_close(steps[:, :, t], s_cut, atol=0, rtol=0)
        one = [x[:, :, t:t + 1].contiguous() for x in (r, k, v, w)]
        _, s = rwkv6_scan(*one, u, s)
        torch.testing.assert_close(steps[:, :, t], s, atol=0, rtol=0)


# ----------------------------------------------------------------------------
# flash_attention's backward kernel, and the other wrappers' refusal of
# autograd
# ----------------------------------------------------------------------------

def _ulps(got, want):
    """max |got - want| in bf16 ulps of max(|want|, 2^-8)."""
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -8))
    return float((diff / torch.ldexp(torch.ones_like(diff), e - 8)).max())


@pytest.mark.parametrize("hd,heads", [(16, (4, 2)), (64, (9, 3)),
                                      (80, (8, 8)), (128, (16, 4)),
                                      (256, (10, 1))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("S,causal,window", [(1, True, 0), (40, True, 0),
                                             (300, True, 0), (300, True, 96),
                                             (77, False, 0), (77, False, 24)])
def test_flash_backward_matches_twin(cuda, hd, heads, dtype, S, causal,
                                     window):
    """dq, dk, dv of the kernel against ref.flash_attention_bwd_ref on the
    same inputs (o from the forward twin): float32 within 2e-5 of
    max(1, max|twin|), bf16 / f16 within 2 bf16 ulps per element (both
    accumulate in float32 and round once); two launches bit-equal."""
    from repro_torch.kernels import flash_attention_bwd
    rng = np.random.default_rng(hd + S)
    H, KVh = heads
    q = _rand(rng, 2, H, S, hd, dtype=dtype, dev=cuda)
    k = _rand(rng, 2, KVh, S, hd, dtype=dtype, dev=cuda)
    v = _rand(rng, 2, KVh, S, hd, dtype=dtype, dev=cuda)
    do = _rand(rng, 2, H, S, hd, dtype=dtype, dev=cuda)
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert torch.equal(g, a), f"d{name}: two launches differ"
        if dtype == torch.float32:
            bound = 2e-5 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound, name
        else:
            assert _ulps(g, w) <= 2, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S,causal,window", [(300, True, 0), (300, True, 96),
                                             (77, False, 0)])
def test_flash_backward_group_split_matches_twin(cuda, dtype, S, causal,
                                                 window):
    """The tensor-core backward's second pass takes one query head a block
    and sums the group's float32 dK / dV partials in head order: 16 query
    heads over one KV head at hd 64 (a sum past 8 heads) within 2 bf16
    ulps of the twin, two launches bit-equal."""
    from repro_torch.kernels import flash_attention_bwd
    rng = np.random.default_rng(S + 16)
    q, do = (_rand(rng, 2, 16, S, 64, dtype=dtype, dev=cuda) for _ in "qd")
    k, v = (_rand(rng, 2, 1, S, 64, dtype=dtype, dev=cuda) for _ in "kv")
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), f"d{name}: two launches differ"
        assert _ulps(g, w) <= 2, name


@pytest.mark.parametrize("hd,heads", [(16, (4, 2)), (64, (9, 3)),
                                      (80, (8, 8)), (256, (10, 1))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S,causal,window", [(40, True, 0), (300, True, 96),
                                             (77, False, 24)])
def test_flash_backward_saved_lse_gives_the_recomputed_bits(
        cuda, hd, heads, dtype, S, causal, window):
    """The tensor-core forward's saved log-sum-exps (what autograd hands
    the backward) give the dq / dk / dv bits of a call without them, for
    which the wrapper runs the forward kernel once more to write them; and
    writing them leaves the forward's output bits as they are."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention import _forward
    rng = np.random.default_rng(hd + S + 1)
    H_, KV_ = heads
    q, do = (_rand(rng, 2, H_, S, hd, dtype=dtype, dev=cuda) for _ in "qd")
    k, v = (_rand(rng, 2, KV_, S, hd, dtype=dtype, dev=cuda) for _ in "kv")
    lse = torch.empty(2, H_, S, dtype=torch.float32, device=cuda)
    o = _forward(q, k, v, causal, window, lse)
    assert torch.equal(o, _forward(q, k, v, causal, window))
    saved = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window,
                                lse=lse)
    before = flash_attention.launches
    recomputed = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                     window=window)
    assert flash_attention.launches == before + 1
    for name, a, b in zip("qkv", saved, recomputed):
        assert torch.equal(a, b), f"d{name}: saved and recomputed lse differ"


def test_flash_autograd_launches_the_backward_kernel(cuda):
    """Under autograd the card's flash_attention carries the gradient to q,
    k and v through the backward kernel (the bits of a direct
    flash_attention_bwd call); under no_grad it records nothing."""
    from repro_torch.kernels import flash_attention_bwd
    rng = np.random.default_rng(7)
    q = _rand(rng, 2, H, 64, HD, dtype=torch.bfloat16, dev=cuda)
    k = _rand(rng, 2, KV, 64, HD, dtype=torch.bfloat16, dev=cuda)
    v = _rand(rng, 2, KV, 64, HD, dtype=torch.bfloat16, dev=cuda)
    do = _rand(rng, 2, H, 64, HD, dtype=torch.bfloat16, dev=cuda)
    with torch.no_grad():
        plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    before = flash_attention_bwd.launches
    o = flash_attention(qs, ks, vs)
    assert o.grad_fn is not None and torch.equal(o, plain)
    o.backward(do)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd(q, k, v, plain, do)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert torch.equal(g, w)


def test_wrappers_refuse_grad_on_cuda(cuda):
    """A kernel with no backward raises under autograd instead of cutting
    the gradient; under no_grad the same call launches."""
    rng = np.random.default_rng(1)
    q = _rand(rng, 2, H, HD, dev=cuda).requires_grad_()
    kp = _rand(rng, 5, BS, KV, HD, dev=cuda)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    ctx = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="paged_attention"):
        paged_attention(q, kp, kp, bt, ctx)
    with torch.no_grad():
        assert paged_attention(q, kp, kp, bt, ctx).grad_fn is None
    r = _rand(rng, 1, 2, 3, 16, dev=cuda).requires_grad_()
    w = torch.rand(1, 2, 3, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(RuntimeError, match="rwkv6_scan"):
        rwkv6_scan(r, r, r, w, u)
    with torch.inference_mode():
        y, _ = rwkv6_scan(r, r, r, w, u)
    assert y.grad_fn is None


# ----------------------------------------------------------------------------
# the bidirectional prefix arm of both flash kernels (paligemma's vision
# prefix), at chip_smoke.py's prefix arms' shapes
# ----------------------------------------------------------------------------

# (B, H, KV, S, hd, prefix, window): paligemma's 8 / 1 heads at hd 256 (256
# patches + 64 text tokens); a prefix straddling a 64-row tile at hd 64,
# with and without a window; the whole sequence as the prefix (MHA)
PREFIX_SHAPES = [(2, 8, 1, 320, 256, 256, 0), (2, 4, 2, 200, 64, 100, 0),
                 (2, 4, 2, 200, 64, 100, 48), (2, 4, 4, 200, 64, 200, 0)]


@pytest.mark.parametrize("B,H_,KV_,S,hd,prefix,window", PREFIX_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_prefix_matches_twin(cuda, B, H_, KV_, S, hd, prefix, window,
                                   dtype):
    """The prefix arm of every route (tensor cores for bf16 / f16, CUDA
    cores for float32), forward and backward (the 16-bit backward on the
    forward's saved log-sum-exps), against the twins: float32 within 2e-5
    of max(1, max|twin|), bf16 / f16 within 2 bf16 ulps; two backward
    launches bit-equal; prefix_len = 0 gives the plain causal call's
    bits."""
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import _forward
    rng = np.random.default_rng(S + hd + prefix + window)
    q, do = (_rand(rng, B, H_, S, hd, dtype=dtype, dev=cuda) for _ in "qd")
    k, v = (_rand(rng, B, KV_, S, hd, dtype=dtype, dev=cuda) for _ in "kv")
    lse = (None if dtype == torch.float32 else
           torch.empty(B, H_, S, dtype=torch.float32, device=cuda))
    o = _forward(q, k, v, True, window, lse, prefix)
    assert torch.equal(flash_attention(q, k, v, window=window,
                                       prefix_len=prefix), o)
    assert torch.equal(flash_attention(q, k, v, window=window, prefix_len=0),
                       flash_attention(q, k, v, window=window))
    got = flash_attention_bwd(q, k, v, o, do, window=window,
                              prefix_len=prefix, lse=lse)
    again = flash_attention_bwd(q, k, v, o, do, window=window,
                                prefix_len=prefix, lse=lse)
    torch.cuda.synchronize()
    want_o = ref.flash_attention_ref(q, k, v, window=window,
                                     prefix_len=prefix)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                       prefix_len=prefix)
    for name, g, a, w in (("o", o, o, want_o),) + tuple(
            zip(("dq", "dk", "dv"), got, again, want)):
        assert torch.equal(g, a), f"{name}: two launches differ"
        if dtype == torch.float32:
            bound = 2e-5 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound, name
        else:
            assert _ulps(g, w) <= 2, name


def test_attention_block_prefix_launches_the_flash_kernels(cuda):
    """attention_block with a vision prefix on the card runs the flash
    kernels' prefix arm, forward and (under autograd) backward, and matches
    the same block on the CPU (the twins) within 2e-5 in float32."""
    from types import SimpleNamespace
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.models import attention
    cfg = SimpleNamespace(n_heads=8, n_kv_heads=1, head_dim=64,
                          rope_theta=10000.0)
    rng = np.random.default_rng(11)
    params = {n: _rand(rng, 256, 512, dtype=torch.float32) * 0.05
              for n in ("wq", "wk", "wv")}
    params["wo"] = _rand(rng, 512, 256) * 0.05
    params["wk"], params["wv"] = params["wk"][:, :64], params["wv"][:, :64]
    x = _rand(rng, 2, 96, 256)
    pos = torch.arange(96, dtype=torch.int32).expand(2, 96)
    want = attention.attention_block(params, x, pos, cfg, prefix_len=40)
    cp = {n: t.to(cuda).requires_grad_() for n, t in params.items()}
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    got = attention.attention_block(cp, x.to(cuda), pos.to(cuda), cfg,
                                    prefix_len=40)
    got.sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    assert float((got.detach().cpu() - want).abs().max()) <= 2e-5 * max(
        1.0, float(want.abs().max()))
    assert all(t.grad is not None for t in cp.values())
