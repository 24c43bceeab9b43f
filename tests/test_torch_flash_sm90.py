"""The Hopper route of the port's flash attention (``sm90_bf16``).

On the CPU: the route rule (which kernel a CUDA call would launch, and
which inputs raise), and a plain emulation of the route's one change of
arithmetic (the probabilities rounded to bf16 before the P.V product,
per KV tile of an online softmax in base 2) against the plain version
and against the reference's Pallas kernel in interpret mode, within the
bf16 tolerance of ``tests/test_kernels.py`` (2e-2).

On the card (``gpu``): the route's kernel against the plain version.
These tests import neither JAX nor the reference, so that
``python -m pytest -m gpu tests/test_torch_flash_sm90.py`` runs on a
machine with a card and no JAX.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (default_scale,
                                                 flash_attention, mha_plain,
                                                 route)
from test_torch_flash_attention import SHAPES, _inputs, ref_flash

torch.set_num_threads(1)

TOL = 2e-2
# the slice's shape (tinyllama prefill: Hq/Hkv = 8, D = 64) narrowed to
# one batch row, one KV group and 512 tokens
SLICE_NARROW = (1, 8, 1, 512, 512, 64, True)
# zamba2's shared block (D 80, Hq = Hkv, causal) narrowed to 2 heads and
# 384 tokens, three KV tiles
ZAMBA2_NARROW = (1, 2, 2, 384, 384, 80, True)
SM90_SHAPES = [s for s in SHAPES if s[5] in (64, 80, 128)] + [
    SLICE_NARROW, ZAMBA2_NARROW]
# decode (Sq = 1) and a ragged query tile, at the other head dim each;
# a ragged tile at D 80 with a KV group
NEW_SHAPES = [(1, 2, 2, 1, 300, 128, True), (1, 4, 2, 257, 512, 64, True),
              (1, 4, 2, 257, 512, 80, True)]
EMPTY_ROWS = (1, 4, 2, 96, 40, 64, True)       # 56 rows see no key
KV_TILE = {64: 128, 80: 128, 128: 64}          # the kernel's BK per D
D_PAD = {64: 64, 80: 128, 128: 128}            # columns in shared memory


def sm90_emulation(q, k, v, *, causal):
    """The sm90 route's arithmetic in plain PyTorch (fp32).

    Per KV tile of the kernel's BK keys: scores times ``scale * log2(e)``
    (both fp32), the running max and denominator in fp32 with the
    reference's guards, ``exp2``, the denominator summed from the
    unrounded probabilities and the P.V product from their bf16
    rounding; one division at the end, output rounded to bf16.  The
    head dim is zero-padded to whole 64-column blocks, as the tensor
    maps fill them (D 80: columns 80-127), and the columns past D are
    dropped from the output, as the kernel's store does.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pad = (0, D_PAD[d] - d)
    k = torch.nn.functional.pad(k.repeat_interleave(hq // hkv, 1).float(),
                                pad)
    v = torch.nn.functional.pad(v.repeat_interleave(hq // hkv, 1).float(),
                                pad)
    q = torch.nn.functional.pad(q.float(), pad)
    sl2 = (torch.tensor(default_scale(d), dtype=torch.float32)
           * torch.tensor(1.4426950408889634, dtype=torch.float32))
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, hq, sq, 1), float("-inf"))
    den = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, D_PAD[d]))
    for k0 in range(0, sk, KV_TILE[d]):
        k1 = min(k0 + KV_TILE[d], sk)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k1]) * sl2
        if causal:
            s = torch.where(torch.arange(k0, k1)[None, :] <= qpos, s,
                            float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        safe = torch.where(mn == float("-inf"), 0.0, mn)
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp2(m - safe))
        p = torch.exp2(s - safe)
        den = alpha * den + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), v[:, :, k0:k1])
        m = mn
    out = acc / torch.where(den == 0, 1.0, den)
    return out[..., :d].to(torch.bfloat16)


def _bf16(x, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# -- the route rule (CPU) -----------------------------------------------------

@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90_bf16"), (torch.bfloat16, 128, "sm90_bf16"),
    (torch.bfloat16, 80, "sm90_bf16"),
    *[(torch.bfloat16, d, "cuda_core") for d in (16, 32, 48, 96, 112)],
    *[(torch.float32, d, "cuda_core") for d in (16, 64, 128)]])
@pytest.mark.parametrize("layout", ["bhsd", "bshd_view"])
def test_route_rule(dtype, d, want, layout):
    """bf16 at D 64, 80 or 128 takes the Hopper kernel, contiguous or
    as the model's (B,H,S,D) views of (B,S,H,D) tensors; the rest stays
    on the CUDA-core kernel."""
    def make(h, s):
        if layout == "bhsd":
            return torch.zeros((2, h, s, d), dtype=dtype)
        return torch.zeros((2, s, h, d), dtype=dtype).transpose(1, 2)

    q, kv = make(8, 33), make(2, 47)
    assert route(q, kv, kv) == want


def test_route_without_keys_stays_on_cuda_cores():
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 0, 64), dtype=torch.bfloat16)
    assert route(q, kv, kv) == "cuda_core"


@pytest.mark.parametrize("case", ["stride", "address"])
def test_route_raises_where_tma_cannot_read(case):
    """A bf16 D=64 input whose strides or address are not multiples of
    16 bytes raises; no other route takes it instead."""
    wide = torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16)
    if case == "stride":     # rows of 68 elements: 136 bytes apart
        x = torch.zeros((1, 2, 16, 68), dtype=torch.bfloat16)[..., :64]
    else:                    # starts 2 bytes into a 16-byte aligned row
        x = wide[..., 1:65]
    ok = wide[..., :64]
    assert route(ok, ok, ok) == "sm90_bf16"
    for args in ((x, ok, ok), (ok, x, ok), (ok, ok, x)):
        with pytest.raises(ValueError, match="TMA"):
            route(*args)


# -- the route's arithmetic (CPU) ---------------------------------------------

@pytest.mark.parametrize("shape", SM90_SHAPES)
def test_bf16_probabilities_stay_within_tolerance(shape):
    """The sm90 route's arithmetic against the plain version and the
    reference's Pallas kernel (interpret mode), both on bf16 inputs."""
    causal = shape[-1]
    q, k, v = _inputs(shape, 13)
    got = sm90_emulation(*(_bf16(x) for x in (q, k, v)),
                         causal=causal).float()
    plain = mha_plain(*(_bf16(x) for x in (q, k, v)), causal=causal).float()
    pallas = torch.from_numpy(ref_flash(q, k, v, causal=causal,
                                        dtype="bfloat16"))
    err = {"plain": float((got - plain).abs().max()),
           "pallas": float((got - pallas).abs().max())}
    print(f"sm90 emulation {shape}: max |err| {err} (bound {TOL})")
    torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got, pallas, atol=TOL, rtol=TOL)


def test_emulation_keeps_empty_rows_zero():
    q, k, v = (_bf16(x) for x in _inputs(EMPTY_ROWS, 7))
    got = sm90_emulation(q, k, v, causal=True)
    assert not got[:, :, :56].any()
    torch.testing.assert_close(got.float(), mha_plain(q, k, v, causal=True)
                               .float(), atol=TOL, rtol=TOL)


# -- the Hopper kernel against its plain version (card only) -----------------

def _run_sm90(q, k, v, causal):
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_route
    assert after["sm90_bf16"] == before["sm90_bf16"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SM90_SHAPES + NEW_SHAPES + [EMPTY_ROWS])
def test_sm90_matches_plain_on_card(cuda, shape):
    causal = shape[-1]
    q, k, v = (_bf16(x, cuda) for x in _inputs(shape, 5))
    got = _run_sm90(q, k, v, causal).float()
    want = mha_plain(q, k, v, causal=causal).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    empty = max(shape[3] - shape[4], 0) if causal else 0
    assert not got[:, :, :empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [130, 2047])
def test_sm90_reads_model_views_on_card(cuda, d, s):
    """(B,H,S,D) views of (B,S,H,D) tensors, as the model hands them."""
    g = torch.Generator(device=cuda).manual_seed(d + s)
    q = torch.randn((2, s, 8, d), generator=g, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((2, s, 2, d), generator=g, device=cuda,
                        dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    got = _run_sm90(q, k, v, True)
    want = mha_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL,
                               rtol=TOL)


@pytest.mark.gpu
def test_fp32_stays_on_cuda_cores_on_card(cuda):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _inputs(SHAPES[0], 1))
    before = dict(flash_attention.launches_by_route)
    flash_attention(q, k, v)
    assert flash_attention.launches_by_route["cuda_core"] == \
        before["cuda_core"] + 1
    assert flash_attention.launches_by_route["sm90_bf16"] == \
        before["sm90_bf16"]
