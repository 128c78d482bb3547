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
ulps at every head dim and block size; paged decode's split is held bit
for bit where the output must not move (a row alone or in any batch, a
non-finite pool past ctx, ctx = 1 giving the token's V row), and each
wrapper that reads with TMA gives the aligned call's bits on bf16 views
off a 16-byte boundary."""
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
def test_paged_attention_batch_invariant(cuda, hd, heads, bs, ctx, dtype):
    """A row's output bits do not depend on the batch: alone, in the
    batch, and in the batch with the other rows' contexts changed."""
    rng = np.random.default_rng(hd + bs)
    q, kp, vp, bt, cl = _paged_batch(rng, dtype, cuda, hd, heads, bs, ctx)
    full = paged_attention(q, kp, vp, bt, cl)
    for b in range(len(ctx)):
        alone = paged_attention(q[b:b + 1], kp, vp, bt[b:b + 1], cl[b:b + 1])
        torch.testing.assert_close(alone[0], full[b], atol=0, rtol=0)
        moved = cl.roll(1)                # every other row's ctx changed
        moved[b] = cl[b]
        others = paged_attention(q, kp, vp, bt, moved)
        torch.testing.assert_close(others[b], full[b], atol=0, rtol=0)
    torch.testing.assert_close(full.float(), ref.paged_attention_ref(
        q, kp, vp, bt, cl).float(), atol=2e-5 if dtype == torch.float32
        else 2e-2, rtol=2e-5 if dtype == torch.float32 else 2e-2)


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
